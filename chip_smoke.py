#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of TPU-SZ, TPU-ZFP, the in-situ snapshot
path, Foresight, in-situ sharded compression, sharded snapshots with the
compressed gradient hop, blockfloat8 serving, the multi-replica router
under the serving fault drill, the trainer and its supervised fault drill,
the MoE, RWKV6, Hymba and enc-dec model families, and the dry run's
predictions on one GPU and check every result.

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc``; it builds the hand-written kernels from
``src/repro_torch/kernels/csrc`` at first use.  In order it:

1. prints the card's name and power limit (``nvidia-smi``) and the kernel
   build time;
2. holds each SZ kernel (K1-K4) against its plain PyTorch version on the
   card, at 256^3 and at a ragged shape, K1, K3 and K4 (K3 and K4 take and
   give the dense stream) also on the hard cases of ``data/sz_cases.py`` (every block
   at width 0, every block at width 32 from +-3e38, NaN and +inf, a ragged
   padded field, values whose quantized value leaves the int32 range),
   requiring bitwise equality of the words with their zero tail, the widths,
   ``total_bits`` and the reconstruction;
3. drives the SZ main path: the six ``nyx_fields(n=256, seed=42)`` fields
   through ``get_compressor("tpu-sz")`` (CUDA, ``kernel`` backend, ``fused``
   path), then through the ``xla`` path, with the launch counts reset just
   before each run and read just after.  The two paths' streams must be
   equal, every kernel of a path must have launched, and ``max|x̂ - x| <= eb
   (1 + 1e-5)`` with ``eb = 1e-4 x value range``.  Prints ratio, PSNR, the
   power-spectrum gate and compress/decompress MB/s (median and range of
   20 CUDA-event-timed calls after a warm-up);
4. checks the card's streams against the plain versions on the CPU for the
   six 64^3 fields;
5. runs the ``core`` backend on the card: baryon density (ABS) and HACC
   ``vx`` (``hacc_particles(grid=128)``) in PW_REL 1e-2 mode, each held to
   its bound;
6. holds each ZFP kernel (K5-K7) against its plain version on the card, at
   the 256^3 baryon density and the ragged vx slice, and on hard blocks
   (+-inf, NaN, 3e38, saturated, zero, subnormal; 1, 31 and 1003 of them)
   at rates 1, 2, 4, 8, 16, 32 and 40, K7 also on streams whose every plane
   carries a full payload, requiring bitwise equality;
7. drives the ZFP main path: the six 256^3 fields through
   ``get_compressor("tpu-zfp")`` at rate 8 (CUDA, ``kernel`` backend,
   ``fused`` path: K6 then K7), then through the ``xla`` path (K5) and the
   ``core`` backend on the card, with the launch counts reset before each
   run and read after.  All three streams must be equal and the ratio
   exactly 4.0; prints PSNR, the power-spectrum gate and compress /
   decompress MB/s (median and range of 20 calls);
8. compresses the paper's 512^3 Nyx side, the 256^3 baryon density tiled
   2 x 2 x 2 on the card (Nyx fields are periodic), through the same entry
   point, whose reconstruction must be the 256^3 one tiled; prints MB/s and
   peak memory;
9. checks the card's ZFP streams against the plain versions on the CPU for
   the six 64^3 fields, and drives HACC ``x`` and ``vx`` (2^21 particles,
   one (32768, 8, 8) partition each) through ``tpu-zfp``;
10. holds K8 and K9 (the arena-batched SZ kernels) against their plain
    versions on the card, bitwise (arena, widths, offsets, counts,
    total_bits, used and the decoded rows), on four of the 256^3 fields (one
    bucket), on three (16, 128, 256) rows with three different bounds, on
    ``sz_cases.rows()`` (ratios more than 4x apart) and on rows at width 0
    and 32; each row's arena slice must be the one-field fused stream and
    K9's rows K4's;
11. drives the snapshot path: a state of the six 256^3 Nyx fields, the six
    HACC arrays (2^21 particles), the ragged vx slice and a 64^3 bfloat16
    baryon density, planned with ``plan_kernel_buckets`` then
    ``plan_buckets`` (the Nyx fields make two kernel buckets, 4 + 2 rows),
    compressed with ``szk_compress_bucket`` (K8) and
    ``sz_compress_bucket(staged=True)``, handed to
    ``CheckpointManager(async_save=True).save`` through ``to_host_async``,
    drained with ``wait()`` and restored on the card; the launch counts are
    reset just before and read just after (K8 exactly 2, K9 exactly 2 from
    ``szk_decompress_bucket``: one launch per bucket each way, since each
    writes or reads the whole arena).  Each leaf's bound is 1e-4 x its own value
    range, passed to the bucket coders as one bound per row.  Every row must
    hold codes (a nonzero
    block width), every row's stream must equal the one-field coder's, every
    restored leaf must lie within its bound in its dtype, and K9 must equal
    K4 per field.  Prints the ratio, the stall until
    ``save()`` returns, the wall and MB/s through ``wait()``, the restore
    MB/s, the peak device memory per kernel bucket, the snapshot stages and
    the files written; at small size the card's payload files must equal
    the plain CPU versions' byte for byte;
12. runs Foresight's CBench (``repro_torch.foresight.cbench.run_sweep``) on
    the card over the six 256^3 fields: ``tpu-sz`` at eb = {1e-2, 1e-3,
    1e-4} x value range and ``tpu-zfp`` at rates 4 and 8, 30 cases, warm-up
    1 and 3 timed calls each way; K3 and K4 must launch exactly 72 times and
    K6 and K7 48, every SZ case hold its bound, every ZFP ratio be 32/rate
    and the eb 1e-4 and rate 8 ratios equal phase 3's and 7's.  Prints each
    case's CBench MB/s (host clock, each call ended by a synchronise) beside
    the CUDA-event MB/s of phases 3 and 7, and writes the rows and a Cinema
    database to the gitignored ``chip_smoke_out/foresight/``;
13. runs the halo gate: ``hacc_particles(grid=64)`` positions (262144
    particles) through ``tpu-zfp`` at rates 8 and 16 on the card and on the
    CPU (streams and reconstructions bitwise equal), their FoF catalogs
    (equal), and ``guideline.evaluate_gates(particles=...)``; prints the
    halo counts and the worst deviation.  FoF and the P(k) gates of phase
    14 run on the host in a pool of spawned processes beside the card's
    work;
14. runs the §V-D guideline on the card: ``best_fit_per_field`` per 256^3
    field over the three SZ bounds must pick the passing configuration of
    highest ratio (the least-bad one where none passes), as the CBench
    reconstructions gated on the host say; at 64^3 the card's picks and
    ratios must equal the CPU's (the CPU pinned to the kernel backend's
    plain versions); then the port's workflow example
    (``examples/torch_foresight_workflow.py``) at n=64 on the card, its
    SLURM scripts and Cinema database written;
15. drives the in-situ sharded path (``repro_torch.dist.insitu``): in a
    one-rank NCCL group in this process the 256^3 baryon density through
    ``sz`` core + halo, ``sz`` kernel and ``zfp`` kernel must give the
    single-device entry points' streams and decodes, bitwise, K3, K4, K6
    and K7 once each; two-process ``gloo`` groups (``pod`` = 2, (128, 256,
    256) shards; both ranks on the one card, and again on the CPU), each
    rank this script run with ``--insitu-rank``, must gather equal streams
    on card and CPU, decode each shard and (``host_decode``) the whole
    field bitwise as the single device does, send only faces, scalars and
    compressed payloads (counted exactly), and launch each kernel once per
    shard; ``CheckpointManager`` saves every host stream as ``insitu-*``
    shard files and restores them on the card, bitwise;
16. snapshots a sharded state (``launch.train.build_insitu_hook``): the
    leaves of phase 11's state placed on a ("pod", "data", "model") mesh
    of (2, 1, 1), two ``gloo`` processes on cuda:0 (and again on the CPU,
    started at the beginning beside phases 2-15), each rank this script
    run with ``--sharded-rank``: baryon and dark-matter density replicated
    (one K8 bucket, the first rank only), temperature split on y (the
    per-leaf route, K3 per shard), vx/vy/vz split on z and the six HACC
    arrays split (flat arenas with the halo), the ragged vx and the
    bfloat16 density replicated (flat arenas, no axis); ``eb`` = 100 for
    every leaf.  Two snapshots in flight (``overlap``, two slots), then a
    restore with ``shardings`` on the pair and, here, on a one-rank NCCL
    mesh.  Every decode (each bucket's, the restores') must equal the
    single-device reference semantics bitwise (the flat leaf through
    ``sz``, K8 rows as the one-field fused stream, the per-leaf route as the
    kernel backend), every value lie within eb, the card pair's files equal
    the CPU pair's byte for byte, each rank's launches and bytes sent be
    exactly as counted (no raw field sent); then the six HACC arrays and
    temperature as raw ``DTensor`` leaves, lossless and ``sz_abs``, saved
    per shard and restored on both meshes; then the compressed cross-pod
    gradient mean (both forms, bits 8 and 4, block 1024, error feedback,
    three steps) of one starcoder2-3b block's gradients at its published
    widths (about 96 M parameters), card == CPU bitwise, the wire exactly
    codes plus scales, ``enabled=False`` the plain mean; prints each
    bucket's compress ms per rank, the stalls, drain and restore walls, the
    ratio, the bytes sent by kind and the hop's ms against
    ``enabled=False`` with the card's name and power limit;
17. prints each of these phases' wall time and their K3, K4, K6, K7, K8
    and K2 launches, which the kernel line below adds to the main paths';
18. holds K10 (decode attention over the blockfloat8 KV cache) against its
    plain version on the card: the dense entry at the reference tests'
    shapes (f32 query, rtol 2e-5 / atol 2e-6), and both entries at the
    serving shape (B=8, S=2048, H=24, Hkv=2, D=128, bf16 query, one lane at
    index -1, which must be exactly 0; the others within one bf16 ulp plus
    2e-6, and the same query in f32 within the f32 tolerance) and at
    S=32768 (``decode_32k``); the paged entry reads a pool of 16-token
    pages through a permuted page table with a page id used twice and an
    unmapped entry at the zero page, against the gather + plain K10.  The
    other paths' shapes are held the same way: qwen3-moe's paged decode of
    phase 27 (B=8, S=2048, H=32, Hkv=4, D=128) and whisper-base's dense
    decode of phase 28 (B=8, S=17, H=Hkv=8, D=64, a lane at position 0, one
    free);
19. serves starcoder2-3b at full width (random bf16 weights drawn on the
    card from a seeded ``torch.Generator``) through ``ServingEngine``:
    8 slots, max_len 2048, paged blockfloat8 pool of 16-token pages,
    greedy, ``attention="auto"``; 12 requests of 256-1024 prompt tokens
    (numpy seed) and 32 new tokens each, so 4 recycle a slot.  The launch
    counts are reset just before and read just after: K10 (its paged
    entry, reading the pool through the page table) must launch 30 times
    per decode step, ``layers._gather_pages`` must not run (the ``xla`` run
    below must run it), every request must get 32 tokens and the pool must
    be clean (``check_kv_integrity``).  A second run must repeat the
    tokens, and an ``attention="xla"`` run (plain attention) must give the
    same first token for every request (it comes from prefill).  Prints
    prefill ms, the median tick, decode tokens/s, K10's share of a tick,
    the pool's bytes, peak device memory and a profiled tick's kernel
    launches and device busy share.  TF32 is off throughout;
20. runs the SMOKE config on the card (K10) and on the CPU (K10's plain
    version, ``attention="fused"``) with the same parameters and prompts:
    greedy tokens agree in at least 6 of 8 per request
    (``tests/test_serving.py``'s bar).  The CPU's ``xla`` path is another
    function in bfloat16 (it rounds attention logits and probabilities to
    bfloat16, as the reference's does), so its agreement is printed only;
21. (printed last, after phases 22-28) prints the ZFP stage times and one
    JSON line of per-kernel numbers for
    K1-K10 (launches, max difference from the plain version (K10's at the
    serving shape with its bf16 query), device ms at the main path's
    shapes from CUDA-graph replays (every wrapper captures), the plain
    version's ms, the bound (bytes at 3.35 TB/s, or the operations of the
    pipe that takes longest: 32-bit integer at 16.7 T/s, conversions and
    leading-zero counts at 4.2 T/s, float32 multiplies at 33.5 T/s), and
    for K10
    ``library_ms``: one ``F.scaled_dot_product_attention`` call over K/V
    dequantized to bf16 beforehand, the GQA repeat included; K10's row is
    its paged entry, the main path's, and its bound counts the page table's
    bytes; K10's dense entry, both at S=32768, K1's and K10's share of
    their bound and their registers and spills are printed before it) and,
    last, ``{"ok": true, "device": {...}}``;
22. serves phase 19's 12 requests through ``serving.router.Router`` over two
    replicas of phase 19's engine configuration sharing one tree of phase
    19's bf16 weights (drawn again from the seed), each with its own paged
    blockfloat8 pool: (a) fault-free, real clock, ``integrity_every=1``:
    every request's tokens equal phase 19's, K10 launches 30 per decode
    step summed over the replicas, pages are gathered only for prefill, both
    pools are clean and no replica is quarantined; (b)
    ``ServeFaultPlan.drill(seed=0, n_replicas=2)`` under a ``DrillClock``
    (the reference tests' router settings): every request completes or is
    shed with a typed reason, never-moved requests equal (a) bitwise, a
    moved request's prefix before its first re-dispatch equals (a), and
    each stretch after a re-dispatch equals what a fresh replica decodes
    from the prefix it was handed (not (a)'s tokens: a re-prefill is
    another bf16 program than K10's decode, and phase 19's plain and K10
    paths part after the first token with random weights); (c) one
    ``kv_poison`` of replica 0's zero page at its tick 2: the integrity
    probe quarantines the replica, no request keeps a token decoded at or
    after the poisoned tick, and the continuations hold as in (b).  Prints the plan,
    the faults fired, quarantines, re-dispatches, routed decode tokens/s,
    ticks and peak memory;
23. trains minicpm-2b at its published widths (2.72 B parameters; float32
    state, bfloat16 compute, AdamW under ``wsd``, batch 8 x 256, the
    launcher's defaults) for 3 steps on a one-rank NCCL ("pod", "data")
    mesh with the compressed pod hop (bits 8, block 1024, error feedback):
    finite losses, every parameter leaf changed, and the hop gathers
    exactly each leaf's codes (padded to whole blocks) plus its scales per
    step.  Prints step ms, tokens/s and peak memory;
24. runs ``launch/train.py main`` on the card with ``--insitu-snapshot
    --ckpt-every 2 --steps 4``: at minicpm-2b's widths cut to one layer,
    the ``fields/`` snapshot restores within ``--insitu-eb`` (the three
    embedding leaves, 2^28 points each, are skipped by the hook, as the
    reference's would be: its 1-D coder refuses 2^26 points or more, which
    is also why ``--lossy-ckpt`` cannot save this state in either package)
    and the step-4 checkpoint bitwise; at SMOKE with ``--lossy-ckpt`` too
    (no leaf reaches its 1 MiB threshold), a restart from the step-2
    checkpoint reproduces steps 3-4's losses and the whole state bitwise;
    and a two-process ``gloo`` pair on cuda:0 (``pod`` = 2, each rank this
    script with ``--train-rank``) takes three compressed-hop steps at SMOKE
    and ends with bitwise-equal parameters on both ranks;
25. runs ``launch/train.py main --supervise --fault-seed 0`` on the card at
    minicpm-2b's widths cut to one layer (``--steps 8 --ckpt-every 2
    --grow-back-after 2 --insitu-snapshot``, flight recorder on): the plan's
    transient drain writes and fetch stall at step 3, its corruption of the
    newest snapshot and a pod loss of nothing (a one-rank mesh) at step 6.
    The injector's log equals the plan, one shrink restores step 4 past the
    one quarantined snapshot, the replayed step's loss holds
    (``shrink-restore``), the grow-back fires at step 6, every loss is
    finite and no kernel launches.  Prints step, snapshot dispatch, quiesce,
    restore and grow-back ms (trace spans) and peak memory;
26. runs the reference's ``test_fault_drill_8dev`` plan on 8 ``gloo`` ranks
    (this script with ``--drill-rank``) on cuda:0 at minicpm-2b SMOKE, at
    its ``{"pod": 2, "data": 2, "model": 2}`` mesh with the state sharded as
    the reference's (FSDP over ``data``, tensor and expert axes over
    ``model``).  Pod loss at step 9, the truncated step-8 snapshot
    quarantined, step 4 restored onto ``{"pod": 1, "data": 2, "model": 2}``
    (ranks 4-7 wait), grow-back at step 8 (each rejoining rank gets the
    blocks of the pod-0 rank at its (data, model) coordinate), step 18
    reached; every rank holds the reference's values and the same losses,
    the two ranks at each (data, model) coordinate hold the same blocks bit
    for bit, and the same drill's CPU group (started beside phases 2-15)
    gives the same transitions and step trace.  Each rank has a timeout.
    Each of phases 22-32 prints its wall time; their kernel launches join
    the line of 21 (25-26, 29 and 32 launch none);
27. serves qwen3-moe-30b-a3b at its published widths cut to 16 of its 48
    layers (``MOE_LAYERS``; d_model 2048, heads 32/4, head dim 128, 128
    experts top-8, d_ff 768 per expert, vocab 151,936: 10.7 B parameters,
    random bf16 weights drawn on the card, the expert stacks a layer slice
    at a time) through phase 19's
    traffic and engine configuration, after every earlier phase's tensors
    are freed.  ``attention="auto"`` must pick K10, K10 launch exactly 16
    times per decode step, decode gather no pages, the pool be clean after
    the drain, a second run give the same tokens (the routed combine adds in
    a fixed order) and the ``attention="xla"`` run launch no K10 and give the
    same first tokens.  The second run, untimed, holds every K10 call
    against the same function in float64 on the same inputs (half a bf16
    ulp plus 2^-24 * V * (L + S): ``K10Held``) and counts the routed
    assignments dropped past an expert's capacity, in decode and in
    prefill.  Prints the share of later tokens that agree with the ``xla``
    run, the drop shares, the median tick, decode tokens/s, prefill ms,
    peak GiB and a profiled tick (launches, device busy share);
28. serves rwkv6-1.6b and hymba-1.5b at their published widths through the
    engine's token-by-token fallback (no prefill, no paged pool, no K10
    route: blockfloat8 ``attention="auto"`` must not pick K10), 6 requests
    through 4 slots (prompts of 8-24 tokens, 12 new), twice with identical
    tokens and clean free lanes; takes one float32 hymba-1.5b decode step at
    its published widths over a random blockfloat8 cache with two lanes
    past the 1024-token window (positions 1250 and 1100, one lane at 300):
    redrawing the positions the windowed layers drop changes nothing bit for
    bit, redrawing them in the three global layers moves the lanes past the
    window, and layer by layer from the card's inputs (its cache writes and
    each layer's input pinned on the CPU) every layer's attention, SSD and
    output and the logits agree card vs CPU within 1e-4 of their largest
    magnitude; runs whisper-base's encoder over 1500 random frames for 8
    lanes, fills the cross-attention memory (``init_cache(params=,
    frames=)``) and decodes 16 greedy steps with a (B,) index at blockfloat8 through K10's dense entry
    (D = 64; exactly 6 launches a step, repeated with the same tokens and
    every K10 call held to float64 as in 27) and through plain attention
    (no K10, the same first tokens); then each of the five new archs at
    SMOKE size, the same bf16 parameters on the card and on the
    CPU: forward logits and every one of 8 blockfloat8 decode steps (K10
    where the model has the route, its plain version on the CPU) within 4
    bf16 ulps of the CPU's largest |logit|;
29. holds the dry run (``repro_torch.launch.dryrun``) against the card.  For
    each cell it traces the step on ``meta`` in this process with the dry
    run's counters, then runs the same step on the card: ``empty_cache`` and
    ``reset_peak_memory_stats`` first, a step under ``FlopCounterMode``,
    then a timed one (ended by ``synchronize``).  Cells: (a) minicpm-2b's
    train step at phase 23's 8 x 256 (one rank, f32 state, bf16 compute);
    (b) one train step each of rwkv6-1.6b, hymba-1.5b and whisper-base at
    their published widths and depths, 8 x 128 (the chunk loops' meta
    traces cost host time per operation); (c) starcoder2-3b's decode step
    on one card at decode_32k's rows of a data rank (8 rows, a
    32768-position cache, codec none); (d) the ``dryrun`` and ``costrun``
    CLIs on one train, prefill and decode cell each, into a scratch folder
    (every cell ``ok``; the CLI's decode cell, the sharded serving step on
    (16, 16), fits below (c)'s peak; phase 31 holds that step's trace on
    the card).  The meta FLOP count must equal
    the card's and the predicted peak lie within ``DRYRUN_PEAK_TOL`` of
    ``max_memory_allocated``; the card's ``total_memory`` must be
    ``dryrun.DEVICE_MEMORY_BYTES``.  Prints both peaks, their ratio, the
    FLOPs, the step ms and TFLOP/s;
30. takes the sharded train step (the reference's FSDP over ``data``;
    Megatron column- and row-parallel attention and MLPs, a vocab-parallel
    embedding and loss, and expert parallelism over ``model``, whose ranks
    share their rows) of phi3.5-moe-42b-a6.6b (1.56 B parameters: 32 q and
    8 kv heads split 16 and 4 a rank, 16 experts 8 a rank), of
    minicpm-2b (36 heads split 18 a rank, dense SwiGLU, the tied 122,753 x
    2304 table vocab-parallel), of rwkv6-1.6b (32 wkv heads split 16 a rank,
    d_ff 3584 a rank) and of hymba-1.5b (25 attention and SSD heads
    replicated, the MLP 2752 a rank), each at its published widths cut to 1
    layer (f32 state and compute, TF32 off), on 4 ``gloo`` ranks on cuda:0
    as ``{"data": 2, "model": 2}`` (this script with ``--step-rank``), 3
    steps of 8 x 256 tokens at lr 1e-3, then the same steps on one
    replicated rank once the others have freed the card, teacher-forced on
    each step's sharded gradient and norm (``STEP_TOL``'s comment says
    why); that rank receives every block over gloo.  Held on every step:
    the four ranks' losses and norms equal; the loss within ``STEP_TOL``;
    the norm over blocks against the norm over whole leaves of the same
    values; each leaf's sharded gradient, and the gradient norm, within
    ``STEP_F32_FACTOR`` times the replicated float32 one's distance from a
    float64 evaluation of the step (each leaf in L2 and in its largest
    element); at the end every parameter, ``m`` and ``v`` element within
    ``STEP_TOL``; each rank's local leaf shapes equal its specs; rank 0's
    peak within ``DRYRUN_PEAK_TOL`` of the dry run's prediction for the
    same mesh (a fake 4-rank group on ``meta``), its ``FlopCounterMode``
    count equal to the trace's, and the bytes its collectives send a step,
    by kind and mesh axis, equal to the trace's (no all-gather over
    ``model`` but the MoE's router and expert outputs).  One in-situ
    snapshot of phi3.5-moe's params through ``build_insitu_hook``, restored
    with ``restore(shardings=)``: coded leaves within the bound, every leaf
    of 1 MiB or more coded or named once as skipped, the small leaves saved
    raw and restored bitwise.  Prints the bytes each rank sent, step ms,
    peaks, each architecture's seconds and the kernel launches (none on
    this path);
31. takes the sharded serving step (``train.step.build_serve_step``: the
    parameters placed as the train state's and gathered in each layer, the
    cache's batch over ``data`` and its sequence over ``model``) of
    starcoder2-3b, qwen3-moe-30b-a3b (64 experts a rank), rwkv6-1.6b and
    hymba-1.5b, each at its published widths cut to 1 layer,
    on 4 ``gloo`` ranks on cuda:0 as ``{"data": 2, "model": 2}`` (this
    script with ``--serve-rank``), f32, over a blockfloat8 cache of 8192
    positions (4096 a ``model`` rank) prefilled on one card (drawn at random
    for rwkv6 and hymba, which have no prefill) and placed with
    ``place_cache``: 8 greedy decode steps each (4 for qwen3-moe) with a
    ``(B,)`` index (prompts of 1000, 4090, 4100
    and 7000 tokens, 4093 and 6000 for qwen3-moe and hymba: lanes on both
    sides of the block border, two crossing it; 12 and 20 for rwkv6), K10
    on each rank's block in every layer with its log-sum-exp where the
    model has the route.  Held: the ranks' tokens equal; each step replayed
    on one card from the sharded run's cache (a recurrent state from the
    prefill's, advanced by the replay) gives the same tokens and MoE
    routing (``top_e``, drop mask), and the sharded logits, and each
    rank's whole recurrent state (rwkv6's ``wkv`` and token shifts, hymba's
    ``ssd_state``: every ``model`` rank holds all heads) after every step,
    lie within ``SERVE_F32_FACTOR`` times that float32 run's distance from a
    float64 evaluation of the step; each rank's K10 ``(out, lse)`` against
    the plain version on its block and a float64 evaluation at two steps
    (:class:`K10Blocks`); K10 launches layers x steps on each rank (none
    for rwkv6 and hymba); each rank's cache bytes its blocks' under the
    placed specs; rank 0's peak within ``DRYRUN_PEAK_TOL`` of the dry
    run's trace of the same step at this mesh, its FLOPs and its bytes sent
    by kind and axis equal to the trace's.  Prints each step's host ms
    (gloo through the host, not a mesh's interconnect) and K10's time at
    the block;
32. serves one hymba-1.5b request of 1100 prompt tokens and 32 new ones
    through the engine's token-by-token path at its published widths cut to
    4 layers (layer 1 windowed at 1024, the others global), float32 weights
    and a dense cache: no K10, and the card's greedy tokens equal the
    CPU's: the ticks that choose them taken again by the CPU's
    ``decode_step`` from the same weights, each from the card's state
    before it (its cache, K/V writes and SSD state pinned: unpinned, the
    random-weight request is chaotic).  Prints the median tick ms.

Any failure raises and exits non-zero; so does a machine without CUDA, and a
directory without the rest of the repository.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import io
import json
import math
import multiprocessing
import os
import pickle
import re
import shutil
import socket
import statistics
import subprocess
import sys
import time
import types
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path
from typing import Iterator

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
sys.path.insert(0, str(Path(__file__).resolve().parent / "tools"))

# These fail, and the script exits non-zero, outside a checkout of the repository.
from repro_torch import kernels  # noqa: E402
from repro_torch import tree as tree_util  # noqa: E402
from repro_torch.analysis import halos, metrics, spectrum  # noqa: E402
from repro_torch.checkpoint import manager as ckpt  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.core import arena  # noqa: E402
from repro_torch.core import bitpack  # noqa: E402
from repro_torch.core import sz as sz_core  # noqa: E402
from repro_torch.core import zfp as zfp_core  # noqa: E402
from repro_torch.core.api import get_compressor  # noqa: E402
from repro_torch.data import cosmo, kvc_cases, sz_cases, zfp_cases  # noqa: E402
from repro_torch.data.tokens import DataConfig, TokenPipeline  # noqa: E402
from repro_torch.dist import insitu, sharding, spmd  # noqa: E402
from repro_torch.dist.collectives import GradCompressionConfig  # noqa: E402
from repro_torch.foresight import cbench, cinema, guideline  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import kvc_attention as k10  # noqa: E402
from repro_torch.kernels import lorenzo3d as lor  # noqa: E402
from repro_torch.kernels import sz_fused as szf  # noqa: E402
from repro_torch.kernels import zfp3d as k5  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402
from repro_torch.kernels import zfp_fused as zff  # noqa: E402
from repro_torch.launch import costrun, dryrun  # noqa: E402
from repro_torch.launch import train as launch_train_lib  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import hybrid as hybrid_lib  # noqa: E402
from repro_torch.models import layers as model_layers  # noqa: E402
from repro_torch.models import moe as moe_lib  # noqa: E402
from repro_torch.models import rwkv6 as rwkv6_lib  # noqa: E402
from repro_torch.models import transformer as transformer_lib  # noqa: E402
from repro_torch.models.spec import init_params, param_count  # noqa: E402
from repro_torch.obs import metrics as obs_metrics  # noqa: E402
from repro_torch.obs import trace as obs_trace  # noqa: E402
from repro_torch.serving.engine import EngineConfig, Request, ServingEngine  # noqa: E402
from repro_torch.serving.faults import DrillClock, ServeFaultInjector, ServeFaultPlan  # noqa: E402
from repro_torch.serving.router import (SHED_REASONS, Router, RouterConfig,  # noqa: E402
                                        RouterRequest)
from repro_torch.train import faults as faults_lib  # noqa: E402
from repro_torch.train import loop as loop_lib  # noqa: E402
from repro_torch.train import step as step_lib  # noqa: E402
from repro_torch.train import supervisor as sup  # noqa: E402

from cuda_timing import cuda_ms, cuda_times, graph_ms  # noqa: E402  (tools/)

N = 256  # Nyx grid side of the main path
HACC_GRID = 128  # HACC particles per side of the core-backend check
SMALL_N = 64  # grid side of the CPU agreement check
SEED = 42
REL_EB = 1e-4  # eb = REL_EB x value range (10.0 on baryon density, as in quickstart)
PW_REL = 1e-2
ZFP_RATE = 8  # quickstart's rate
ZFP_CHECK_RATES = (1, 2, 4, 8, 16, 32, 40)  # rates of the kernel-vs-plain checks (one above 32)
ZFP_HARD_COUNTS = (1, 31, 1003)  # block counts of the hard-block checks: no multiple of a CTA's
TIMING_ITERS = 20  # timed calls (or CUDA-graph replays per round) per kernel, stage and field
PLAIN_ITERS = 3
SNAPSHOT_DIR = Path(__file__).resolve().parent / ".chip_smoke_snapshots"  # gitignored
K_ROWS = 4  # rows of the first kernel bucket: 4 x 2^24 points fill ROW_ELEM_BUDGET
# a one-device mesh as the bucket planners read one (axis names and sizes):
# every leaf of the single-process snapshot is replicated
ONE_DEVICE = types.SimpleNamespace(shape=(1,), mesh_dim_names=("data",))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
# Peak operation rates per pipe: 132 SMs at the 1.98 GHz boost clock, times
# the per-SM throughputs of compute capability 9.0 (CUDA C++ Programming
# Guide, arithmetic instructions): 64 32-bit integer operations a clock
# (add, shift, logic, min/max), 16 conversions between float32 and int32 or
# leading-zero counts, 128 float32 multiplies.  The data sheet's 67 TFLOP/s
# FP32 counts an FMA as two operations on those 128 lanes; half of it is
# twice the INT32 pipe.
INT32_OPS_PER_S = 132 * 64 * 1.98e9
CVT_OPS_PER_S = 132 * 16 * 1.98e9
F32_OPS_PER_S = 67e12  # H100 SXM FP32 outside the tensor cores, an FMA as two (data sheet)
PIPE_OPS_PER_S = {"int32": INT32_OPS_PER_S, "cvt": CVT_OPS_PER_S,
                  "f32": F32_OPS_PER_S / 2}  # a multiply takes an FMA's slot
BF16_OPS_PER_S = 989e12  # H100 SXM dense bf16 on the tensor cores (data sheet)

ARCH = "starcoder2-3b"  # the JAX launcher's example (repro/launch/serve.py:8)
SERVE = dict(batch_slots=8, max_len=2048, page_size=16, codec="blockfloat8", paged=True)
SERVE_REQUESTS, SERVE_NEW, PROMPT_LEN = 12, 32, (256, 1024)
KVC_SERVE_SHAPE = (8, 2048, 24, 2, 128)  # B, S, H, Hkv, D at starcoder2-3b's serving
KVC_LONG_S = registry.SHAPES["decode_32k"].seq_len
SMOKE_REQUESTS, SMOKE_NEW = 4, 8

# Operations per point, by pipe: the least work the function needs, whatever
# a kernel issues (K3/K4 quantize a plane twice and scan with shuffles; none
# of that is charged).  int32: Lorenzo 7; zigzag 2, block max 1, packing 6;
# prefix sums 3; unpacking 6, unzigzag 3.  f32 and cvt: the quantizer's
# multiply and rounding conversion (the dequantizer's conversion and
# multiply), and the bit length's leading-zero count.  The stream's offsets
# (a scan of one width per 64 points) round to nothing per point.
# K8 and K9 do K3's and K4's work per point.
OPS_PER_POINT = {"lorenzo3d_quantize": {"int32": 7, "f32": 1, "cvt": 1},
                 "lorenzo3d_reconstruct": {"int32": 3, "f32": 1, "cvt": 1},
                 "fused_compress": {"int32": 16, "f32": 1, "cvt": 2},
                 "fused_decompress": {"int32": 12, "f32": 1, "cvt": 1}}
OPS_PER_POINT.update(fused_compress_batched=OPS_PER_POINT["fused_compress"],
                     fused_decompress_batched=OPS_PER_POINT["fused_decompress"])

# Operations the ZFP functions need per 64-point block, by pipe, counted as
# the least work one thread's registers allow, whatever a kernel issues: no
# idle lanes, no loop or address work; data moves (loads, stores, the
# sequency permutation) count 0, and a three-input logic function, a funnel
# shift or a byte permute counts one, as each is one instruction.
# Stages 1-3 (K5, K6): |x| 64 and their max 63 over the IEEE bits, the
# exponent, nonzero test and scale bits 6, 48 four-point lifts of 16,
# negabinary 2 a point; the scale multiply and the rounding, 1 a point each.
ZFP_FORWARD = {"int32": 64 + 63 + 6 + 48 * 16 + 64 * 2, "f32": 64, "cvt": 64}
# Group tops: each group's OR by three-input ORs (sizes 1, 3, 6, 10, 12, 12,
# 10, 6, 3, 1: 30), then its bit length, a leading-zero count and a subtract.
ZFP_TOPS = {"int32": 30 + 10, "cvt": 10}
# K7's stages 1-3 inverted: negabinary 2 a point, 48 inverse lifts of 16, the
# scale bits 4; the conversion and the scale multiply, 1 a point each.
ZFP_INVERSE = {"int32": 64 * 2 + 48 * 16 + 4, "f32": 64, "cvt": 64}
# The coder (K6, K7), all int32.  Per block: two 32x32 bit transposes
# (Hacker's Delight 7-3), each 2 rounds of 32 byte permutes and 3 rounds of
# 16 word pairs at 4 (two shifts, two three-input selects); the layout: each
# group's entry plane 10, the first of them 9, the plane width as each group
# enters 10, and at the plane that spends the budget its kept width 2 and
# two masks 4.
ZFP_CODER_BLOCK = 2 * (2 * 32 + 3 * 16 * 4) + (10 + 9 + 10 + 6)
# Per plane that keeps bits: the budget test, the offset's advance, its word
# and shift 4; the encoder then places the payload (shift and merge into the
# word it carries 2, two funnel shifts 2, the next carried word 2), the
# decoder fetches it (two funnel shifts 2).
ZFP_ENC_PLANE, ZFP_DEC_PLANE = 4 + 6, 4 + 2
# Per group absent from such a plane (a present group costs nothing): its
# test, and squeezing its zero run out (or putting it back), a funnel shift,
# a shift and a three-input merge.  Plane and run counts come from this
# run's headers.
ZFP_ABSENT_RUN = 4


def add_ops(*parts) -> dict[str, int]:
    """Sum of ``(count, {pipe: operations})`` parts, per pipe."""
    out: dict[str, int] = {}
    for count, ops in parts:
        for pipe, v in ops.items():
            out[pipe] = out.get(pipe, 0) + count * v
    return out


def zfp_ops(gtops, rate: int) -> dict[str, dict[str, int]]:
    """Operations per pipe that K5, K6 and K7 need on the blocks whose
    headers are ``gtops`` at ``rate``: the coder's share follows the planes
    that keep bits and the groups absent from them."""
    nb = gtops.shape[0]
    _, keep = zfp_core._plane_offsets(gtops, rate * 64 - zfp_core._HEADER_BITS)
    kept = keep > 0
    planes = torch.arange(32, device=gtops.device)
    absent = gtops.to(torch.int64)[:, None, :] + planes[None, :, None] < 32
    n_kept, n_absent = int(kept.sum()), int((absent & kept[..., None]).sum())
    transform = [(nb, ZFP_FORWARD), (nb, ZFP_TOPS)]
    coder = [(nb, {"int32": ZFP_CODER_BLOCK}), (n_absent, {"int32": ZFP_ABSENT_RUN})]
    return {"zfp3d_transform": add_ops(*transform),
            "fused_compress_blocks": add_ops(*transform, *coder,
                                             (n_kept, {"int32": ZFP_ENC_PLANE})),
            "fused_decompress_blocks": add_ops((nb, ZFP_INVERSE), *coder,
                                               (n_kept, {"int32": ZFP_DEC_PLANE}))}


KERNELS = {
    "lorenzo3d_quantize": ("K1", "src/repro_torch/kernels/csrc/lorenzo3d.cu",
                           "src/repro/kernels/lorenzo3d.py:72"),
    "lorenzo3d_reconstruct": ("K2", "src/repro_torch/kernels/csrc/lorenzo3d.cu",
                              "src/repro/kernels/lorenzo3d.py:101"),
    "fused_compress": ("K3", "src/repro_torch/kernels/csrc/sz_fused.cu",
                       "src/repro/kernels/sz_fused.py:177"),
    "fused_decompress": ("K4", "src/repro_torch/kernels/csrc/sz_fused.cu",
                         "src/repro/kernels/sz_fused.py:336"),
    "zfp3d_transform": ("K5", "src/repro_torch/kernels/csrc/zfp3d.cu",
                        "src/repro/kernels/zfp3d.py:116"),
    "fused_compress_blocks": ("K6", "src/repro_torch/kernels/csrc/zfp_fused.cu",
                              "src/repro/kernels/zfp_fused.py:84"),
    "fused_decompress_blocks": ("K7", "src/repro_torch/kernels/csrc/zfp_fused.cu",
                                "src/repro/kernels/zfp_fused.py:161"),
    "fused_compress_batched": ("K8", "src/repro_torch/kernels/csrc/sz_fused.cu",
                               "src/repro/kernels/sz_fused.py:238"),
    "fused_decompress_batched": ("K9", "src/repro_torch/kernels/csrc/sz_fused.cu",
                                 "src/repro/kernels/sz_fused.py:361"),
    "kvc_decode_attention": ("K10", "src/repro_torch/kernels/csrc/kvc_attention.cu",
                             "src/repro/kernels/kvc_attention.py:68"),
}
SZ_KERNELS = ("lorenzo3d_quantize", "lorenzo3d_reconstruct", "fused_compress", "fused_decompress")


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def bits(t):
    """A tensor's raw bits as a comparable integer tensor (uint32 is viewed
    as int32, float32 as int32)."""
    if t.dtype in (torch.uint32, torch.float32):
        return t.view(torch.int32)
    return t


def max_abs_diff(a, b) -> float:
    if a.dtype == torch.float32:
        return float((a - b).abs().max())
    return float((bits(a).to(torch.int64) - bits(b).to(torch.int64)).abs().max())


def same(a, b) -> bool:
    """Bitwise equality (a card tensor is compared on the host with a CPU one)."""
    a, b = bits(a), bits(b)
    if a.device != b.device:
        a, b = a.cpu(), b.cpu()
    return a.shape == b.shape and bool(torch.equal(a, b))


def pad_to_tile(x):
    pads = [(-s) % t for s, t in zip(x.shape, lor.TILE)]
    return F.pad(x, (0, pads[2], 0, pads[1], 0, pads[0])).contiguous()


def hold_stream(got, want, label: str) -> float:
    """Two SZ streams equal word for word (zero tail included), width for
    width and in total_bits; returns the largest word difference (0)."""
    check(same(got.widths, want.widths), f"K3 widths differ from plain at {label}")
    check(got.total_bits.dtype == torch.int64 and int(got.total_bits) == int(want.total_bits),
          f"K3 total_bits {int(got.total_bits)} != {int(want.total_bits)} at {label}")
    err = max_abs_diff(got.words, want.words)
    check(same(got.words, want.words), f"K3 words differ from plain at {label} (max |diff| {err})")
    return err


def kernels_vs_plain(inputs: dict, device) -> dict[str, float]:
    """Each kernel against its plain version on the same CUDA inputs; bitwise
    equality required, K3/K4 also on the hard cases of ``sz_cases``.  Returns
    the largest difference per kernel (0)."""
    worst = {name: 0.0 for name in SZ_KERNELS}

    def hold_k3_k4(xp, eb_i, label):
        packed = szf.fused_compress(xp, eb_i)
        worst["fused_compress"] = max(worst["fused_compress"], hold_stream(
            packed, szf.fused_compress_plain(xp, eb_i), label))
        got = szf.fused_decompress(packed, tuple(xp.shape), eb_i)
        want = szf.fused_decompress_plain(packed, tuple(xp.shape), eb_i)
        err = max_abs_diff(got, want)
        check(same(got, want), f"fused_decompress differs from plain at {label} (max |diff| {err})")
        worst["fused_decompress"] = max(worst["fused_decompress"], err)

    for label, (x, eb) in inputs.items():
        xp = pad_to_tile(x)
        eb_i = lor.guarded_eb(xp, eb)
        delta = lor.lorenzo3d_quantize(xp, eb_i)
        pairs = {"lorenzo3d_quantize": (delta, lor.lorenzo3d_quantize_plain(xp, eb_i)),
                 "lorenzo3d_reconstruct": (lor.lorenzo3d_reconstruct(delta, eb_i),
                                           lor.lorenzo3d_reconstruct_plain(delta, eb_i))}
        for name, (got, want) in pairs.items():
            err = max_abs_diff(got, want)
            check(same(got, want), f"{name} differs from plain at {label} (max |diff| {err})")
            worst[name] = max(worst[name], err)
        hold_k3_k4(xp, eb_i, label)
        print(f"kernels vs plain at {label} {tuple(xp.shape)}: bitwise equal")
    for label, (x, eb_i) in sz_cases.cases(SEED).items():
        x, eb_i = x.to(device), eb_i.to(device)
        got, want = lor.lorenzo3d_quantize(x, eb_i), lor.lorenzo3d_quantize_plain(x, eb_i)
        check(same(got, want), f"lorenzo3d_quantize differs from plain at {label}")
        hold_k3_k4(x, eb_i, label)
    print(f"K1 and K3/K4 vs plain on the hard cases {list(sz_cases.cases(SEED))}: K1's residuals, "
          "K3/K4's streams (zero tail included), widths, total_bits and reconstructions bitwise "
          "equal")
    return worst


def zfp_kernels_vs_plain(inputs: dict, device) -> dict[str, float]:
    """K5-K7 against their plain versions on the same CUDA inputs, at every
    rate of ZFP_CHECK_RATES: on each field's blocks, on the hard blocks at
    ZFP_HARD_COUNTS, and K7 on full-payload streams; bitwise equality
    required."""
    worst = {"zfp3d_transform": 0.0, "fused_compress_blocks": 0.0,
             "fused_decompress_blocks": 0.0}

    def hold(name, got, want, label):
        for g, w in zip(got, want):
            err = max_abs_diff(g, w)
            check(same(g, w), f"{name} differs from plain at {label} (max |diff| {err})")
            worst[name] = max(worst[name], err)

    def hold_all(label, blocks):
        hold("zfp3d_transform", k5.zfp3d_transform(blocks), k5.zfp3d_transform_plain(blocks),
             label)
        for rate in ZFP_CHECK_RATES:
            enc = zff.fused_compress_blocks(blocks, rate)
            hold("fused_compress_blocks", enc, zff.fused_compress_blocks_plain(blocks, rate),
                 f"{label} rate {rate}")
            hold("fused_decompress_blocks", [zff.fused_decompress_blocks(*enc, rate)],
                 [zff.fused_decompress_blocks_plain(*enc, rate)], f"{label} rate {rate}")

    for label, x in inputs.items():
        blocks = zfp_core._carve_blocks(x)
        hold_all(label, blocks)
        for rate in ZFP_CHECK_RATES:  # K6 and K7 on the field itself, the compressors' entry
            enc = zff.fused_compress_field(x, rate)
            hold("fused_compress_blocks", enc, zff.fused_compress_blocks_plain(blocks, rate),
                 f"{label} field rate {rate}")
            hold("fused_decompress_blocks", [zff.fused_decompress_field(*enc, rate, x.shape)],
                 [zfp_core._uncarve_blocks(zff.fused_decompress_blocks_plain(*enc, rate),
                                           x.shape)], f"{label} field rate {rate}")
        print(f"ZFP kernels vs plain at {label} {tuple(x.shape)}, rates {ZFP_CHECK_RATES}, on "
              "its carved blocks and on the field itself: bitwise equal")
    for nb in ZFP_HARD_COUNTS:
        blocks = zfp_cases.hard_blocks(nb, SEED + nb).to(device)
        hold_all(f"{nb} hard blocks", blocks)
        for rate in ZFP_CHECK_RATES:
            full = [t.to(device) for t in zfp_cases.full_streams(nb, rate, SEED + nb + rate)]
            hold("fused_decompress_blocks", [zff.fused_decompress_blocks(*full, rate)],
                 [zff.fused_decompress_blocks_plain(*full, rate)],
                 f"{nb} full-payload streams rate {rate}")
    print(f"ZFP kernels vs plain on the hard blocks (+-inf, NaN, 3e38, saturated, zero, "
          f"subnormal) at {ZFP_HARD_COUNTS} blocks and K7 on full-payload streams, rates "
          f"{ZFP_CHECK_RATES}: bitwise equal")
    return worst


def error_bound_ok(x, xr, eb: float) -> float:
    check(xr.shape == x.shape, f"shape {tuple(xr.shape)} != {tuple(x.shape)}")
    check(bool(torch.isfinite(xr).all()), "non-finite reconstruction")
    err = float((xr - x).abs().max())
    check(err <= eb * (1 + 1e-5), f"max |x̂ - x| = {err} > eb = {eb}")
    return err


def main_path(fields: dict, device) -> dict[str, int]:
    """The six fields through the default entry point (fused), then the xla
    path; returns each kernel's launches in the run of its path."""
    comp = get_compressor("tpu-sz")
    check(comp.device.type == "cuda", "the default compressor is not on CUDA")
    xs = {k: torch.from_numpy(v).to(device) for k, v in fields.items()}
    ebs = {k: REL_EB * float(v.max() - v.min()) for k, v in fields.items()}

    kernels.reset_launch_counts()
    fused = {}
    for name, x in xs.items():
        r = comp.compress(x, eb=ebs[name])
        xr = comp.decompress(r)
        check(r.meta.get("backend") == "kernel", "default backend on CUDA is not kernel")
        fused[name] = (r, xr)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    launches = {k: counts[k] for k in ("fused_compress", "fused_decompress")}

    kernels.reset_launch_counts()
    for name, x in xs.items():
        packed, padded, eb_i = ops.sz_compress_kernel(x, ebs[name], path="xla")
        xr = ops.sz_decompress_kernel(packed, padded, x.shape, eb_i, path="xla")
        r, xr_f = fused[name]
        kp = r.payload["kpacked"]
        check(same(packed.words, kp.words) and same(packed.widths, kp.widths)
              and int(packed.total_bits) == int(kp.total_bits), f"{name}: fused and xla streams differ")
        check(same(xr, xr_f), f"{name}: fused and xla reconstructions differ")
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    launches.update({k: counts[k] for k in ("lorenzo3d_quantize", "lorenzo3d_reconstruct")})
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the main path")
    print("main path launches: " + json.dumps(launches))

    for name, x in xs.items():
        r, xr = fused[name]
        err = error_bound_ok(x, xr, ebs[name])
        orig, recon = fields[name], xr.cpu().numpy()
        d = metrics.distortion(orig, recon)
        ok, dev = spectrum.pk_gate(orig, recon)
        rates = rate_line(comp, lambda: comp.compress(x, eb=ebs[name]), r, ("tpu-sz", name),
                          {"eb": ebs[name]})
        print(f"{name:20s} eb={ebs[name]:.6g} ratio={r.ratio:.4f} bitrate={r.bitrate:.4f} "
              f"psnr={d.psnr:.4f}dB max_err={err:.6g} pk_gate={'PASS' if ok else 'FAIL'} "
              f"(dev {dev:.6f}) {rates}")
    return launches


def agrees_with_cpu(small: dict, device) -> None:
    """The card's streams and reconstructions equal the plain versions' on
    the CPU (which the tests hold to the JAX package) at 64^3."""
    gpu = get_compressor("tpu-sz", device=device)
    cpu = get_compressor("tpu-sz", backend="kernel", device="cpu")
    for name, v in small.items():
        eb = REL_EB * float(v.max() - v.min())
        rg, rc = gpu.compress(v, eb=eb), cpu.compress(v, eb=eb)
        pg, pc = rg.payload["kpacked"], rc.payload["kpacked"]
        check(same(pg.words, pc.words) and same(pg.widths, pc.widths)
              and rg.nbytes == rc.nbytes, f"{name}: card and CPU streams differ at {SMALL_N}^3")
        check(same(gpu.decompress(rg), cpu.decompress(rc)),
              f"{name}: card and CPU reconstructions differ at {SMALL_N}^3")
    torch.cuda.synchronize()
    print(f"card == plain CPU versions on the six {SMALL_N}^3 fields: streams and reconstructions")


def core_backend(baryon, vx, device) -> None:
    comp = get_compressor("tpu-sz", backend="core")
    x = torch.from_numpy(baryon).to(device)
    eb = REL_EB * float(baryon.max() - baryon.min())
    r = comp.compress(x, eb=eb)
    err = error_bound_ok(x, comp.decompress(r), eb)
    print(f"core backend baryon_density: ratio={r.ratio:.4f} max_err={err:.6g} (eb {eb:.6g})")

    v = torch.from_numpy(vx).to(device)
    r = comp.compress(v, pw_rel=PW_REL)
    vr = comp.decompress(r)
    check(vr.shape == v.shape and bool(torch.isfinite(vr).all()), "HACC vx: bad reconstruction")
    nz = v != 0
    rel = float((vr[nz] / v[nz] - 1.0).abs().max())
    check(rel <= PW_REL * 1.05, f"HACC vx: pointwise relative error {rel} > {PW_REL} x 1.05")
    check(bool((vr[~nz] == 0).all()), "HACC vx: exact zeros not kept")
    print(f"core backend HACC vx (grid {HACC_GRID}, pw_rel {PW_REL}): ratio={r.ratio:.4f} "
          f"max_rel_err={rel:.6g}")


def rate_line(comp, compress, r, key=None, config=None) -> str:
    """Compress and decompress MB/s of one field: median [slowest..fastest]
    of TIMING_ITERS CUDA-event-timed entry-point calls after a warm-up;
    ``compress()`` compresses the field, ``r`` is its result.  With a
    ``key``, the medians, ratio and ``config`` are kept in ``EVENT_MBS`` for
    the CBench phase to print beside its own."""
    mb = r.raw_nbytes / 1e6
    out, med = [], {}
    for what, fn in (("compress", compress), ("decompress", lambda: comp.decompress(r))):
        ms = sorted(cuda_times(fn, TIMING_ITERS))
        med[what] = mb / statistics.median(ms) * 1e3
        out.append(f"{what}={med[what]:.1f}MB/s "
                   f"[{mb / ms[-1] * 1e3:.1f}..{mb / ms[0] * 1e3:.1f}]")
    if key is not None:
        EVENT_MBS[key] = {**med, "ratio": r.ratio, "config": config}
    return " ".join(out)


def peak_mib(fn) -> float:
    """Peak device memory of one call of ``fn`` above what was allocated before."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2**20


def same_zfp(a, b) -> bool:
    return (same(a.words, b.words) and same(a.emax, b.emax) and same(a.gtops, b.gtops)
            and tuple(a.shape) == tuple(b.shape) and a.rate == b.rate)


def zfp_main_path(fields: dict, device) -> dict[str, int]:
    """The six fields through the default ``tpu-zfp`` entry point (fused),
    then the xla path and the core backend on the card; returns each
    kernel's launches in the run of its path."""
    comp = get_compressor("tpu-zfp")
    check(comp.device.type == "cuda", "the default ZFP compressor is not on CUDA")
    xs = {k: torch.from_numpy(v).to(device) for k, v in fields.items()}

    kernels.reset_launch_counts()
    fused = {}
    for name, x in xs.items():
        r = comp.compress(x, rate=ZFP_RATE)
        fused[name] = (r, comp.decompress(r))
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    launches = {k: counts[k] for k in ("fused_compress_blocks", "fused_decompress_blocks")}

    kernels.reset_launch_counts()
    for name, x in xs.items():
        c = ops.zfp_compress_kernel(x, ZFP_RATE, path="xla")
        r, xr = fused[name]
        check(same_zfp(c, r.payload["parts"][0]), f"{name}: ZFP fused and xla streams differ")
        check(same(ops.zfp_decompress_kernel(c, path="xla"), xr),
              f"{name}: ZFP fused and xla reconstructions differ")
    torch.cuda.synchronize()
    launches["zfp3d_transform"] = kernels.launch_counts()["zfp3d_transform"]
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the ZFP main path")
    print("ZFP main path launches: " + json.dumps(launches))

    core = get_compressor("tpu-zfp", backend="core")
    for name, x in xs.items():
        rc = core.compress(x, rate=ZFP_RATE)
        r, xr = fused[name]
        check(same_zfp(rc.payload["parts"][0], r.payload["parts"][0]),
              f"{name}: ZFP fused and core streams differ")
        check(same(core.decompress(rc), xr), f"{name}: ZFP fused and core reconstructions differ")
    print("ZFP fused == xla == core on the card: streams and reconstructions, six fields")

    for name, x in xs.items():
        r, xr = fused[name]
        check(r.meta.get("backend") == "kernel", "default ZFP backend on CUDA is not kernel")
        check(r.ratio == 4.0, f"{name}: ZFP ratio {r.ratio} != 32 / {ZFP_RATE}")
        check(xr.shape == x.shape and bool(torch.isfinite(xr).all()),
              f"{name}: bad ZFP reconstruction")
        orig, recon = fields[name], xr.cpu().numpy()
        d = metrics.distortion(orig, recon)
        ok, dev = spectrum.pk_gate(orig, recon)
        rates = rate_line(comp, lambda: comp.compress(x, rate=ZFP_RATE), r, ("tpu-zfp", name),
                          {"rate": ZFP_RATE})
        print(f"zfp {name:20s} rate={ZFP_RATE} ratio={r.ratio:.4f} bitrate={r.bitrate:.4f} "
              f"psnr={d.psnr:.4f}dB max_err={d.max_abs_err:.6g} "
              f"pk_gate={'PASS' if ok else 'FAIL'} (dev {dev:.6f}) {rates}")
    return launches


def zfp_nyx_512(base) -> None:
    """The paper's 512^3 Nyx side: the 256^3 field tiled 2 x 2 x 2 on the
    card.  256 is a multiple of 4, so every block of the tiled field is a
    block of the 256^3 one and the reconstruction is the 256^3 one tiled."""
    comp = get_compressor("tpu-zfp")
    x = base.repeat(2, 2, 2)
    r = comp.compress(x, rate=ZFP_RATE)
    xr = comp.decompress(r)
    check(r.ratio == 4.0 and r.payload["parts"][0].words.shape[0] == 2**21,
          f"512^3: ratio {r.ratio}, blocks {r.payload['parts'][0].words.shape[0]}")
    small = comp.decompress(comp.compress(base, rate=ZFP_RATE))
    check(same(xr, small.repeat(2, 2, 2)), "512^3 reconstruction is not the 256^3 one tiled")
    pc = peak_mib(lambda: comp.compress(x, rate=ZFP_RATE))
    pd = peak_mib(lambda: comp.decompress(r))
    rates = rate_line(comp, lambda: comp.compress(x, rate=ZFP_RATE), r)
    print(f"zfp 512^3 tiled baryon_density rate={ZFP_RATE} ratio={r.ratio:.4f} "
          f"{rates} peak_mib compress={pc:.1f} decompress={pd:.1f}")


def zfp_agrees_with_cpu(small: dict, device) -> None:
    gpu = get_compressor("tpu-zfp", device=device)
    cpu = get_compressor("tpu-zfp", backend="kernel", device="cpu")
    for name, v in small.items():
        rg, rc = gpu.compress(v, rate=ZFP_RATE), cpu.compress(v, rate=ZFP_RATE)
        check(same_zfp(rg.payload["parts"][0], rc.payload["parts"][0]) and rg.nbytes == rc.nbytes,
              f"{name}: card and CPU ZFP streams differ at {SMALL_N}^3")
        check(same(gpu.decompress(rg), cpu.decompress(rc)),
              f"{name}: card and CPU ZFP reconstructions differ at {SMALL_N}^3")
    torch.cuda.synchronize()
    print(f"ZFP card == plain CPU versions on the six {SMALL_N}^3 fields: streams and "
          "reconstructions")


def zfp_hacc(hacc, device) -> None:
    """HACC x and vx (one partition each, (N/64) x 8 x 8) through tpu-zfp,
    the stream held to the core backend on the card."""
    comp = get_compressor("tpu-zfp")
    core = get_compressor("tpu-zfp", backend="core")
    for name in ("x", "vx"):
        v = torch.from_numpy(hacc.fields[name]).to(device)
        r = comp.compress(v, rate=ZFP_RATE)
        vr = comp.decompress(r)
        part = r.payload["parts"][0]
        check(tuple(part.shape) == (v.shape[0] // 64, 8, 8), f"HACC {name}: shape {part.shape}")
        check(same_zfp(part, core.compress(v, rate=ZFP_RATE).payload["parts"][0]),
              f"HACC {name}: ZFP kernel and core streams differ")
        check(vr.shape == v.shape and bool(torch.isfinite(vr).all()),
              f"HACC {name}: bad reconstruction")
        d = metrics.distortion(hacc.fields[name], vr.cpu().numpy())
        rates = rate_line(comp, lambda: comp.compress(v, rate=ZFP_RATE), r)
        print(f"zfp HACC {name} (grid {HACC_GRID}, {v.shape[0]} particles, "
              f"{part.words.shape[0]} blocks) rate={ZFP_RATE} ratio={r.ratio:.4f} "
              f"psnr={d.psnr:.4f}dB {rates}")


def zfp_stage_times(x) -> dict[str, float]:
    """Median ms of each stage of one ZFP compress and decompress of ``x``
    on both paths (CUDA-graph replays), beside the whole entry-point calls
    (event pairs), and the peak device memory of one entry-point call each.
    The fused path's K6 and K7 read and write the field (``K6.field``,
    ``K7.field``); the same kernels on its carved blocks (the arena's entry:
    the blocks as the field (4 nb, 4, 4)), with the carve and uncarve copies
    that route needs, are timed beside them."""
    comp = get_compressor("tpu-zfp")
    r = comp.compress(x, rate=ZFP_RATE)
    c = r.payload["parts"][0]
    blocks = zfp_core._carve_blocks(x)
    dec = zff.fused_decompress_blocks(c.words, c.emax, c.gtops, ZFP_RATE)
    u, _, gtops = k5.zfp3d_transform(blocks)
    perm = zfp_core._index(zfp_core.PERM, x.device)
    entry = {
        "zfp.fused.compress": lambda: comp.compress(x, rate=ZFP_RATE),
        "zfp.fused.decompress": lambda: comp.decompress(r),
        "zfp.xla.decompress.core_decompress": lambda: zfp_core.decompress(c),
    }
    stages = {
        "zfp.fused.compress.K6.field": lambda: zff.fused_compress_field(x, ZFP_RATE),
        "zfp.fused.decompress.K7.field": lambda: zff.fused_decompress_field(
            c.words, c.emax, c.gtops, ZFP_RATE, c.shape),
        "zfp.blocks.compress.carve": lambda: zfp_core._carve_blocks(x),
        "zfp.blocks.compress.K6": lambda: zff.fused_compress_blocks(blocks, ZFP_RATE),
        "zfp.blocks.decompress.K7": lambda: zff.fused_decompress_blocks(
            c.words, c.emax, c.gtops, ZFP_RATE),
        "zfp.blocks.decompress.uncarve": lambda: zfp_core._uncarve_blocks(dec, c.shape),
        "zfp.xla.compress.K5": lambda: k5.zfp3d_transform(blocks),
        "zfp.xla.compress.permute+encode_words": lambda: zfp_core.encode_words(
            u.view(torch.int32)[:, perm], gtops, ZFP_RATE),
    }
    # the entry points event-timed per call (their host work, index copies
    # included, is part of them); the stages, which neither sync nor copy
    # from the host, from CUDA-graph replays
    out = {name: cuda_ms(fn, TIMING_ITERS) for name, fn in entry.items()}
    out.update({name: graph_ms(fn) for name, fn in stages.items()})
    out["zfp.fused.compress.peak_mib"] = peak_mib(lambda: comp.compress(x, rate=ZFP_RATE))
    out["zfp.fused.decompress.peak_mib"] = peak_mib(lambda: comp.decompress(r))
    return out


# ------------------------------------------------ K8 / K9 and snapshots ----


def same_stream(h, i: int, packed) -> bool:
    """Row ``i`` of host arena ``h`` is ``packed``'s stored stream."""
    ref = bitpack.to_storage(packed)
    ls = arena.leaf_stream(h, i)
    return (ls["words"].shape == ref["words"].shape and bool((ls["words"] == ref["words"]).all())
            and bool((ls["widths"] == ref["widths"]).all())
            and ls["total_bits"] == int(packed.total_bits))


def batched_vs_plain(inputs: dict) -> dict[str, float]:
    """K8 and K9 against their plain versions on the same CUDA inputs,
    bitwise (the arena with its zero tail and every sidecar, the decoded
    rows); each row's arena slice against the one-field fused stream (K3)
    and K9's rows against K4's."""
    worst = {"fused_compress_batched": 0.0, "fused_decompress_batched": 0.0}
    for label, (x, eb_i) in inputs.items():
        shape = tuple(x.shape[1:])
        enc = szf.fused_compress_batched(x, eb_i)
        for what, got, want in zip(("arena", "widths", "offsets", "counts", "total_bits", "used"),
                                   enc, szf.fused_compress_batched_plain(x, eb_i)):
            err = max_abs_diff(got, want)
            check(same(got, want), f"K8 {what} differs from plain at {label} (max |diff| {err})")
            worst["fused_compress_batched"] = max(worst["fused_compress_batched"], err)
        ar, wrows, offs, counts, tbits, used = enc
        rows = szf.fused_decompress_batched(ar, wrows, shape, eb_i)
        want = szf.fused_decompress_batched_plain(ar, wrows, shape, eb_i)
        err = max_abs_diff(rows, want)
        check(same(rows, want), f"K9 differs from plain at {label} (max |diff| {err})")
        worst["fused_decompress_batched"] = max(worst["fused_decompress_batched"], err)
        del want
        pos = 0
        for b in range(x.shape[0]):
            packed = szf.fused_compress(x[b], eb_i[b])
            ref = bitpack.to_storage(packed)
            cnt = int(counts[b])
            check(int(offs[b]) == pos and cnt == ref["words"].shape[0]
                  and same(ar[pos:pos + cnt], torch.from_numpy(ref["words"].view("int32")))
                  and same(wrows[b], packed.widths) and int(tbits[b]) == int(packed.total_bits),
                  f"row {b} of the K8 arena is not the fused one-field stream at {label}")
            check(same(rows[b], szf.fused_decompress(packed, shape, eb_i[b])),
                  f"row {b} of K9 differs from K4 at {label}")
            pos += cnt
        check(int(used) == pos, f"K8 arena used {int(used)} != {pos} at {label}")
        print(f"K8/K9 vs plain at {label} {tuple(x.shape)}: bitwise equal; rows equal the "
              "one-field K3/K4 streams")
    return worst


def snapshot_state(fields: dict, hacc, small: dict, device) -> dict:
    """The in-situ snapshot's state: six Nyx fields, six HACC arrays, the
    ragged vx slice (flat route) and a 64^3 bfloat16 baryon density."""
    vx = torch.from_numpy(fields["vx"]).to(device)
    return {"nyx": {k: torch.from_numpy(v).to(device) for k, v in fields.items()},
            "hacc": {k: torch.from_numpy(hacc.fields[k]).to(device) for k in cosmo.HACC_FIELDS},
            "vx_ragged": vx[:200, :130, :250].contiguous(),
            "baryon64_bf16": torch.from_numpy(small["baryon_density"]).to(device).to(torch.bfloat16)}


def plan_snapshot(state: dict):
    """Kernel buckets first (``plan_kernel_buckets``), the rest flat.  Each
    leaf's absolute bound is 1e-4 x its own value range (range / eb = 1e4,
    inside the guarded regime), as the one-field phases set it; a bucket's
    bounds are one float32 tensor [rows] on the leaves' device, so the
    snapshot makes no host-to-device copy for them.  Returns the leaves,
    the kernel and flat buckets, and each bucket's bounds."""
    leaves = dict(tree_util.tree_flatten_with_path(state)[0])
    entries = [(name, tuple(x.shape), x.dtype, ()) for name, x in leaves.items()
               if arena.is_float_leaf(x)]
    kbuckets, rest = insitu.plan_kernel_buckets(entries, ONE_DEVICE)
    fbuckets = arena.plan_buckets([e[:3] for e in rest])

    def bucket_eb(b):
        ebs = [REL_EB * float(leaves[n].float().max() - leaves[n].float().min())
               for n in b.names]
        return torch.tensor(ebs, dtype=torch.float32, device=leaves[b.names[0]].device)

    return (leaves, kbuckets, fbuckets, [bucket_eb(b) for b in kbuckets],
            [bucket_eb(b) for b in fbuckets])


def snapshot(leaves: dict, kbuckets, fbuckets, keb: list, feb: list, mgr, step: int,
             device=None):
    """One in-situ snapshot: every bucket compressed on ``device`` (one K8
    launch per kernel bucket on the card), its D2H deferred, and the whole
    snapshot handed to the manager's drain thread.  Returns the state
    handed to ``save`` and the device arenas."""
    snap, arenas = {}, {}
    for k, (b, eb) in enumerate(zip(kbuckets, keb)):
        a = arena.szk_compress_bucket([leaves[n] for n in b.names], b, eb, device=device)
        snap[f"karena{k:03d}"] = arena.to_host_async(a, b, codec=arena.CODEC_SZK)
        arenas[f"karena{k:03d}"] = (a, b)
    for k, (b, eb) in enumerate(zip(fbuckets, feb)):
        a = arena.sz_compress_bucket([leaves[n] for n in b.names], b, eb, staged=True,
                                     device=device)
        snap[f"farena{k:03d}"] = arena.to_host_async(a, b)
        arenas[f"farena{k:03d}"] = (a, b)
    mgr.save(step, snap)
    return snap, arenas


def snapshot_path(fields: dict, hacc, small: dict, device) -> dict[str, int]:
    """The snapshot main path at full size (module docstring, phase 11);
    returns K8's and K9's launches in its run."""
    state = snapshot_state(fields, hacc, small, device)
    leaves, kbuckets, fbuckets, keb, feb = plan_snapshot(state)
    check([b.rows for b in kbuckets] == [K_ROWS, 6 - K_ROWS]
          and all(n.startswith("['nyx']") for b in kbuckets for n in b.names),
          f"kernel buckets {[b.names for b in kbuckets]}")
    check(sum(b.rows for b in fbuckets) == 8, f"flat buckets {[b.names for b in fbuckets]}")
    raw = sum(b.nbytes_raw for b in kbuckets + fbuckets)
    print(f"snapshot plan: kernel buckets {[b.rows for b in kbuckets]}, flat buckets "
          f"{[(b.rows, b.padded) for b in fbuckets]} (rows, P), eb per row "
          f"{[[float(f'{e:.6g}') for e in eb.tolist()] for eb in keb + feb]}, "
          f"{raw / 2**20:.1f} MiB raw; zstd {'on' if ckpt._zstd is not None else 'off'}")
    shutil.rmtree(SNAPSHOT_DIR, ignore_errors=True)
    mgr = ckpt.CheckpointManager(SNAPSHOT_DIR, keep_last=3, async_save=True)
    like = {f"{p}arena{k:03d}": 0 for p, bs in (("k", kbuckets), ("f", fbuckets))
            for k in range(len(bs))}

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    snap, arenas = snapshot(leaves, kbuckets, fbuckets, keb, feb, mgr, 1)
    ebs = {f"{p}arena{k:03d}": eb for p, eb_list in (("k", keb), ("f", feb))
           for k, eb in enumerate(eb_list)}
    res = mgr.wait()
    out, _ = mgr.restore(step=1, state_like=like)
    decoded = {k: arena.szk_decompress_bucket(*arenas[k]) for k in arenas if k[0] == "k"}
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    launches = {k: counts[k] for k in ("fused_compress_batched", "fused_decompress_batched")}
    print("snapshot path launches: " + json.dumps({k: v for k, v in counts.items() if v}))
    # one K8 launch per kernel bucket (it writes the bucket's whole arena) and
    # one K9 launch per bucket decoded by szk_decompress_bucket
    check(launches == {"fused_compress_batched": 2, "fused_decompress_batched": 2},
          f"K8/K9 launches per snapshot {launches}, want 2 and 2")
    check(res.step == 1 and res.nbytes_raw == raw, f"save result {res}")

    worst = {"arena-szk": 0.0, "arena-sz": 0.0}
    for key, (a, b) in arenas.items():
        h = snap[key].result()  # resolved on the drain thread; cached
        codec = arena.CODEC_SZK if key[0] == "k" else arena.CODEC_SZ
        check(h.codec == codec, f"{key}: codec {h.codec}")
        flat_rows = None if key[0] == "k" else arena.sz_decode_rows(
            a.arena, a.widths, a.offsets, a.counts, a.eb_i)
        for i, name in enumerate(b.names):
            x = leaves[name]
            eb = float(ebs[key][i])  # the row's float32 bound
            got = out[key][name]
            check(got.dtype == x.dtype and tuple(got.shape) == tuple(x.shape) and not got.is_cuda,
                  f"{name}: restored {got.dtype} {tuple(got.shape)}")
            check(bool(a.widths[i].any()), f"{name}: every block width is 0 at eb {eb}")
            if key[0] == "k":
                packed, padded, eb_i = ops.sz_compress_kernel(x, eb)
                check(same_stream(h, i, packed), f"{name}: arena row != fused one-field stream")
                k4 = ops.sz_decompress_kernel(packed, padded, x.shape, eb_i, path="fused")
                check(same(decoded[key][i], k4), f"{name}: K9 differs from K4")
                check(same(got, k4), f"{name}: restored (K2 path) differs from K4")
                xf = x
            else:
                xf = x.float().reshape(-1)
                check(same_stream(h, i, sz_core.compress(xf, eb).packed),
                      f"{name}: arena row != sz.compress on the flat leaf")
                dec = flat_rows[i, :xf.numel()].reshape(x.shape)
                check(same(got, dec.to(x.dtype)), f"{name}: restored leaf != its decoded row")
                got, xf = dec, x.float()  # the bound holds before a bf16 cast
            err = float((got.to(device).float() - xf.float()).abs().max())
            check(bool(torch.isfinite(got).all()) and err <= eb * (1 + 1e-5),
                  f"{name}: max |x^ - x| = {err} > eb = {eb}")
            worst[codec] = max(worst[codec], err / eb)
    print(f"snapshot step 1: every row holds codes and equals its one-field stream; restored "
          f"leaves within eb (max err/eb: {json.dumps(worst)}); K9 == K4 == restore per Nyx "
          "field")
    del out, decoded, snap, arenas

    # timed snapshot (allocator and pinned pools warm), then timed restore
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    snap, arenas = snapshot(leaves, kbuckets, fbuckets, keb, feb, mgr, 2)
    stall = time.perf_counter() - t0
    res = mgr.wait()
    wall = time.perf_counter() - t0
    del snap, arenas
    t0 = time.perf_counter()
    out, _ = mgr.restore(step=2, state_like=like)
    restore_s = time.perf_counter() - t0
    files = {p.name: p.stat().st_size for p in sorted((SNAPSHOT_DIR / "step_000000002").iterdir())}
    print(f"snapshot step 2: ratio={res.ratio:.4f} raw={res.nbytes_raw} stored={res.nbytes_stored} "
          f"save_returns_ms={stall * 1e3:.3f} wall_ms={wall * 1e3:.3f} "
          f"MB/s={res.nbytes_raw / 1e6 / wall:.1f} restore_ms={restore_s * 1e3:.3f} "
          f"restore_MB/s={res.nbytes_raw / 1e6 / restore_s:.1f}")
    print("snapshot files (bytes): " + json.dumps(files))
    del out

    for k, (b, eb) in enumerate(zip(kbuckets, keb)):
        xs = [leaves[n] for n in b.names]
        pc = peak_mib(lambda: arena.szk_compress_bucket(xs, b, eb))
        a = arena.szk_compress_bucket(xs, b, eb)
        pd = peak_mib(lambda: arena.szk_decompress_bucket(a, b))
        print(f"kernel bucket {k} ({b.rows} x {b.shapes[0]}): peak_mib compress={pc:.1f} "
              f"decompress={pd:.1f}")
    print("snapshot stages (median ms): " + json.dumps(
        snapshot_stages(leaves, kbuckets[0], fbuckets, keb[0], feb)))
    return launches


def snapshot_stages(leaves: dict, kb, fbuckets, eb_k, feb: list) -> dict[str, float]:
    """Median ms of the stages of one kernel bucket's compress (stack +
    bounds, K8, which writes the arena) and decode (K9, which reads it), and
    of each flat bucket's compress, CUDA-event timed."""
    xs = [leaves[n] for n in kb.names]
    x = torch.stack([t.float() for t in xs])
    eb_i = sz_core.internal_bound(x.abs().amax(dim=(1, 2, 3)), eb_k)
    a = arena.szk_compress_bucket(xs, kb, eb_k)
    stages = {
        f"szk_compress_bucket[{kb.rows}]": lambda: arena.szk_compress_bucket(xs, kb, eb_k),
        "szk.stack+bounds": lambda: sz_core.internal_bound(
            torch.stack([t.float() for t in xs]).abs().amax(dim=(1, 2, 3)), eb_k),
        "szk.K8": lambda: szf.fused_compress_batched(x, eb_i),
        f"szk_decompress_bucket[{kb.rows}]": lambda: arena.szk_decompress_bucket(a, kb),
        "szk.K9": lambda: szf.fused_decompress_batched(a.arena, a.widths, kb.shapes[0], a.eb_i),
    }
    for b, eb in zip(fbuckets, feb):
        fx = [leaves[nm] for nm in b.names]
        stages[f"sz_compress_bucket[{b.rows}x{b.padded}]"] = (
            lambda fx=fx, b=b, eb=eb: arena.sz_compress_bucket(fx, b, eb, staged=True))
    return {name: cuda_ms(fn, TIMING_ITERS // 2) for name, fn in stages.items()}


def snapshot_agrees_with_cpu(fields: dict, hacc, device) -> None:
    """At small size the card's snapshot payload files equal the plain CPU
    versions' byte for byte (kernel and flat routes)."""
    state = {"f": {k: torch.from_numpy(fields[k][:16, :64, :128].copy())
                   for k in ("baryon_density", "temperature")},
             "h": torch.from_numpy(hacc.fields["vx"][:5000].copy()),
             "g": torch.from_numpy(fields["vy"][:3, :50, :7].copy()).to(torch.bfloat16)}
    dirs = {}
    for dev in (device, torch.device("cpu")):
        on = {"f": {k: v.to(dev) for k, v in state["f"].items()}, "h": state["h"].to(dev),
              "g": state["g"].to(dev)}
        d = SNAPSHOT_DIR / f"small_{dev.type}"
        mgr = ckpt.CheckpointManager(d, async_save=True, policy=ckpt.CodecPolicy(zstd_level=0),
                                     device=dev)
        snapshot(*plan_snapshot(on), mgr, 1, device=dev)
        mgr.wait()
        dirs[dev.type] = d / "step_000000001"
    names = sorted(p.name for p in dirs["cuda"].glob("*.bin"))
    check(names == sorted(p.name for p in dirs["cpu"].glob("*.bin")) and len(names) >= 2,
          f"small snapshot files differ: {names}")
    for nm in names + ["MANIFEST.json"]:
        check((dirs["cuda"] / nm).read_bytes() == (dirs["cpu"] / nm).read_bytes(),
              f"small snapshot: {nm} differs between the card and the CPU")
    print(f"snapshot card == plain CPU versions at small size: {len(names)} payload files and "
          "the manifest byte for byte")


def sz_stream_bytes(n: int, rows: int, used: int, decode: bool) -> int:
    """Bytes the SZ stream functions must move for ``rows`` TILE-padded
    fields of ``n`` points whose payloads take ``used`` words in all.
    Encode (K3, K8): f32 in, the word buffer of capacity ``rows * (n + 2)``
    out once (payload and zero tail), a width byte per block, the look-back
    flags (8 B per chunk and the ticket) and the row descriptors.  Decode
    (K4, K9): the payload and the widths in, f32 out."""
    nb = rows * n // 64
    if decode:
        return 4 * used + nb + 4 * rows * n + 4 * rows
    chunks = rows * n // szf.CHUNK_POINTS
    return 4 * rows * n + 4 * rows * (n + 2) + nb + 8 * (chunks + 1) + 4 * rows + 16 * rows


def batched_kernel_times(xb, eb_i) -> dict[str, dict]:
    """Device ms of K8 and K9 (CUDA-graph replays) and their plain versions'
    event-timed ms at the snapshot's (4, 256, 256, 256) bucket, beside the
    bound from this run's bytes (:func:`sz_stream_bytes`: K9 reads the payload
    words this data needs) and operations (:func:`timed`)."""
    shape = tuple(xb.shape[1:])
    n = xb[0].numel()
    enc = szf.fused_compress_batched(xb, eb_i)
    used = int(enc[5])
    runs = {
        "fused_compress_batched": (lambda: szf.fused_compress_batched(xb, eb_i),
                                   lambda: szf.fused_compress_batched_plain(xb, eb_i),
                                   sz_stream_bytes(n, xb.shape[0], used, decode=False)),
        "fused_decompress_batched": (
            lambda: szf.fused_decompress_batched(enc[0], enc[1], shape, eb_i),
            lambda: szf.fused_decompress_batched_plain(enc[0], enc[1], shape, eb_i),
            sz_stream_bytes(n, xb.shape[0], used, decode=True)),
    }
    return {name: timed(kernel, plain, nbytes, add_ops((xb.numel(), OPS_PER_POINT[name])))
            for name, (kernel, plain, nbytes) in runs.items()}


def timed(kernel, plain, nbytes: int, ops: dict[str, int]) -> dict:
    """A kernel's device ms from CUDA-graph replays (``ms``; its wrapper
    makes no host sync, so it captures) beside an event pair around one
    direct call (``call_ms``: the ctypes launch's host time included), its
    plain version's event-timed ms, and the bound: the larger of the bytes
    over the memory rate and the operations over their pipe's rate, for the
    pipe that takes longest (``pipes_ms``: each pipe's time)."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    pipes_ms = {pipe: v / PIPE_OPS_PER_S[pipe] * 1e3 for pipe, v in ops.items()}
    ops_ms = max(pipes_ms.values())
    return {"ms": graph_ms(kernel), "call_ms": cuda_ms(kernel, TIMING_ITERS),
            "plain_ms": cuda_ms(plain, PLAIN_ITERS), "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes_ms": bytes_ms, "ops_ms": ops_ms, "pipes_ms": pipes_ms}



def kernel_times(x, eb: float) -> dict[str, dict]:
    """Device ms of each kernel (CUDA-graph replays) and its plain version's
    event-timed ms at the main path's 256^3 shape, beside the bound from
    this run's bytes and operations (for K6 and K7 the operations of this
    run's headers, :func:`zfp_ops`; :func:`timed`)."""
    xp = pad_to_tile(x)
    shape = tuple(xp.shape)
    n = xp.numel()
    eb_i = lor.guarded_eb(xp, eb)
    delta = lor.lorenzo3d_quantize(xp, eb_i)
    packed = szf.fused_compress(xp, eb_i)
    used = 2 * int(packed.widths.to(torch.int64).sum())  # the words K4 must read for this data
    ops = {name: add_ops((n, OPS_PER_POINT[name])) for name in SZ_KERNELS}
    runs = {
        "lorenzo3d_quantize": (lambda: lor.lorenzo3d_quantize(xp, eb_i),
                               lambda: lor.lorenzo3d_quantize_plain(xp, eb_i), 8 * n),
        "lorenzo3d_reconstruct": (lambda: lor.lorenzo3d_reconstruct(delta, eb_i),
                                  lambda: lor.lorenzo3d_reconstruct_plain(delta, eb_i), 8 * n),
        "fused_compress": (lambda: szf.fused_compress(xp, eb_i),
                           lambda: szf.fused_compress_plain(xp, eb_i),
                           sz_stream_bytes(n, 1, used, decode=False)),
        "fused_decompress": (lambda: szf.fused_decompress(packed, shape, eb_i),
                             lambda: szf.fused_decompress_plain(packed, shape, eb_i),
                             sz_stream_bytes(n, 1, used, decode=True)),
    }
    # ZFP at the main path's rate; headers at the format's 11 B per block.  K6
    # and K7 on the field itself, as the compressors launch them; their plain
    # versions on its carved blocks
    blocks = zfp_core._carve_blocks(x)
    zb = blocks.shape[0]
    zn = 64 * zb  # points of the carved blocks
    enc = zff.fused_compress_field(x, ZFP_RATE)
    ops.update(zfp_ops(enc[2], ZFP_RATE))
    stream_bytes = 4 * zfp_core.payload_words(ZFP_RATE) * zb + 11 * zb
    runs.update({
        "zfp3d_transform": (lambda: k5.zfp3d_transform(blocks),
                            lambda: k5.zfp3d_transform_plain(blocks), 8 * zn + 11 * zb),
        "fused_compress_blocks": (lambda: zff.fused_compress_field(x, ZFP_RATE),
                                  lambda: zff.fused_compress_blocks_plain(blocks, ZFP_RATE),
                                  4 * x.numel() + stream_bytes),
        "fused_decompress_blocks": (lambda: zff.fused_decompress_field(*enc, ZFP_RATE, x.shape),
                                    lambda: zff.fused_decompress_blocks_plain(*enc, ZFP_RATE),
                                    stream_bytes + 4 * x.numel()),
    })
    return {name: timed(kernel, plain, nbytes, ops[name])
            for name, (kernel, plain, nbytes) in runs.items()}


def stage_times(x, eb: float) -> dict[str, float]:
    """Median ms of each stage of one compress and one decompress of ``x`` at
    the main path's shape, on both paths, beside the whole entry-point calls,
    and the peak device memory of one entry-point call each."""
    comp = get_compressor("tpu-sz")
    xp = pad_to_tile(x)
    shape = tuple(xp.shape)
    eb_i = lor.guarded_eb(xp, eb)
    packed = szf.fused_compress(xp, eb_i)
    delta = lor.lorenzo3d_quantize(xp, eb_i)
    r = comp.compress(x, eb=eb)
    stages = {
        "fused.compress": lambda: comp.compress(x, eb=eb),
        "fused.compress.guarded_eb": lambda: lor.guarded_eb(xp, eb),
        "fused.compress.K3": lambda: szf.fused_compress(xp, eb_i),
        "fused.compress.total_bits_readback": lambda: int(packed.total_bits),
        "fused.decompress": lambda: comp.decompress(r),
        "fused.decompress.K4": lambda: szf.fused_decompress(packed, shape, eb_i),
        "xla.compress.K1": lambda: lor.lorenzo3d_quantize(xp, eb_i),
        "xla.compress.pack_codes": lambda: bitpack.pack_codes(szf.tile_major_flatten(delta)),
        "xla.decompress.unpack_codes": lambda: szf.tile_major_unflatten(
            bitpack.unpack_codes(packed), shape),
        "xla.decompress.K2": lambda: lor.lorenzo3d_reconstruct(delta, eb_i),
    }
    out = {name: cuda_ms(fn, TIMING_ITERS) for name, fn in stages.items()}
    out["fused.compress.peak_mib"] = peak_mib(lambda: comp.compress(x, eb=eb))
    out["fused.decompress.peak_mib"] = peak_mib(lambda: comp.decompress(r))
    return out


# ------------------------------------------------------------ serving ----


def bf16_check(got, want, atol: float = 2e-6) -> int:
    """|got - want| <= one bf16 ulp of want plus ``atol`` (an element near 0,
    a sum that cancels, differs by several of its own tiny ulps at the f32
    rounding error of another summation order).  Returns the largest
    distance in ulps, for the record."""
    w = want.float()
    ulp = torch.ldexp(torch.ones_like(w), torch.frexp(w.abs())[1] - 8)
    diff = (got.float() - w).abs()
    check(bool((diff <= torch.where(w == 0, 0.0, ulp) + atol).all()),
          f"K10 bf16 output beyond one ulp (+{atol}) of the plain version")
    return int(((diff / ulp.clamp_min(2.0 ** -133)).ceil()).max())


def kvc_inputs(b, s, h, hkv, d, qdtype, index, device, seed=SEED):
    g = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn(b, h, d, generator=g, device=device).to(qdtype)
    kc, vc = (torch.randint(-127, 128, (b, s, hkv, d), generator=g, device=device,
                            dtype=torch.int8) for _ in range(2))
    ks, vs = (torch.rand(b, s, hkv, generator=g, device=device) * 1.9e-2 + 1e-3
              for _ in range(2))
    idx = torch.as_tensor(np.asarray(index, np.int32)).to(device)
    return q, kc, ks, vc, vs, idx


def serving_index(b: int, s: int, seed: int = SEED) -> list[int]:
    """Per-lane positions like a decode tick of phase 13: prompts of 256-1024
    tokens part-way through their 32 new ones; lane 0 is free (-1)."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(PROMPT_LEN[0], PROMPT_LEN[1] + 1, size=b) + rng.integers(0, SERVE_NEW,
                                                                                  size=b)
    idx = np.minimum(idx, s - 1)
    idx[0] = -1
    return [int(i) for i in idx]


def short_index(b: int, s: int, seed: int = SEED) -> list[int]:
    """Per-lane positions over a short cache (whisper's decode): lane 0 at
    position 0 (one key), the last lane at the cache's end, one lane free."""
    rng = np.random.default_rng(seed + 2)
    idx = rng.integers(1, s - 1, size=b)
    idx[0], idx[1], idx[-1] = 0, -1, s - 1
    return [int(i) for i in idx]


def long_index(b: int, s: int, seed: int = SEED) -> list[int]:
    rng = np.random.default_rng(seed + 1)
    idx = rng.integers(s // 2, s, size=b)
    idx[0], idx[-1] = -1, s - 1
    return [int(i) for i in idx]


def kvc_pool(b, s, h, hkv, d, qdtype, index, device, seed=SEED):
    """The paged form of :func:`kvc_inputs` (``data/kvc_cases.py``): 16-token
    pages every lane maps in a random order, one page id used twice, and an
    unmapped entry at the zero page."""
    return kvc_cases.paged_pool(b, s, h, hkv, d, qdtype, index, device, seed,
                                page=SERVE["page_size"])


def k10_vs_plain(device) -> float:
    """K10 against its plain version on the card (phase 12), both entries.
    Returns the largest |kernel - plain| of the paged entry (the main path's)
    at the serving shape with the bf16 query the main path gives it (the
    report row's ``max_abs_err``); the largest in float32 over every case is
    printed beside it."""
    worst, serving_err = 0.0, 0.0

    def hold_f32(label, b, s, h, hkv, d, index):
        nonlocal worst
        args = kvc_inputs(b, s, h, hkv, d, torch.float32, index, device)
        got, want = k10.kvc_decode_attention(*args), kref.kvc_decode_attention_ref(*args)
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-6, msg=f"K10 at {label}")
        dead = [i for i, n in enumerate(np.atleast_1d(index)) if n < 0]
        for i in dead:
            check(bool((got[i] == 0).all()), f"K10 lane {i} at index -1 is not exactly 0 ({label})")
        worst = max(worst, float((got - want).abs().max()))

    for b, s, h, d in ((1, 128, 4, 64), (2, 256, 8, 64), (2, 384, 2, 128)):
        hold_f32(f"({b}, {s}, {h}, {d}) index {s - 5}", b, s, h, h, d, s - 5)
    hold_f32("(4, 256, 4, 64) per-lane index", 4, 256, 4, 4, 64, [3, 100, 251, 17])
    hold_f32("(2, 128, 4, 64) dead lane", 2, 128, 4, 4, 64, [-1, 64])
    print("K10 vs plain at the reference tests' shapes (f32 q): within rtol 2e-5 / atol 2e-6")

    for label, (b, s, h, hkv, d), index in (
            ("serving", KVC_SERVE_SHAPE, serving_index),
            ("decode_32k", KVC_SERVE_SHAPE[:1] + (KVC_LONG_S,) + KVC_SERVE_SHAPE[2:], long_index),
            (f"{WHISPER} decode", whisper_kvc_shape(), short_index)):
        idx = index(b, s)
        q, kc, ks, vc, vs, ix = kvc_inputs(b, s, h, hkv, d, torch.bfloat16, idx, device)
        got = k10.kvc_decode_attention(q, kc, ks, vc, vs, ix)
        want = kref.kvc_decode_attention_ref(q, kc, ks, vc, vs, ix)
        free = [i for i, n in enumerate(idx) if n < 0]
        check(bool((got[free] == 0).all()), f"K10 free lane not exactly 0 at {label}")
        ulps = bf16_check(got, want)
        q32 = q.float()
        got32 = k10.kvc_decode_attention(q32, kc, ks, vc, vs, ix)
        want32 = kref.kvc_decode_attention_ref(q32, kc, ks, vc, vs, ix)
        torch.testing.assert_close(got32, want32, rtol=2e-5, atol=2e-6, msg=f"K10 f32 at {label}")
        err = float((got32 - want32).abs().max())
        worst = max(worst, err)
        err16 = float((got.float() - want.float()).abs().max())
        if label == "serving":
            serving_err = err16
        print(f"K10 vs plain at {label} (B={b}, S={s}, H={h}, Hkv={hkv}, D={d}, bf16 q, "
              f"index {idx}): free lane exactly 0, largest distance {ulps} bf16 ulps "
              f"(max |diff| {err16:.3g}); f32 q max |diff| {err:.3g}")
        del q, kc, ks, vc, vs, got, want, got32, want32

    for label, (b, s, h, hkv, d), index in (
            ("serving", KVC_SERVE_SHAPE, serving_index),
            ("decode_32k", KVC_SERVE_SHAPE[:1] + (KVC_LONG_S,) + KVC_SERVE_SHAPE[2:], long_index),
            (f"{MOE_ARCH} serving", moe_kvc_shape(), serving_index)):
        idx = index(b, s)
        errs = {}
        for qdtype in (torch.bfloat16, torch.float32):
            args = kvc_pool(b, s, h, hkv, d, qdtype, idx, device)
            got = k10.kvc_decode_attention_paged(*args)
            want = kref.kvc_decode_attention_paged_ref(*args)
            check(bool((got[0] == 0).all()), f"K10 paged free lane not exactly 0 at {label}")
            if qdtype == torch.float32:
                torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-6,
                                           msg=f"K10 paged f32 at {label}")
                worst = max(worst, float((got - want).abs().max()))
            else:
                errs["ulps"] = bf16_check(got, want)
            errs[str(qdtype)] = float((got.float() - want.float()).abs().max())
            del args, got, want
        if label == "serving":
            serving_err = errs[str(torch.bfloat16)]
        print(f"K10 paged vs plain (gather + plain K10) at {label} (B={b}, capacity {s} in "
              f"{SERVE['page_size']}-token pages, H={h}, Hkv={hkv}, D={d}, index {idx}, "
              f"permuted table, a page id used twice): free "
              f"lane exactly 0, bf16 q within {errs['ulps']} ulps (max |diff| "
              f"{errs[str(torch.bfloat16)]:.3g}), f32 q max |diff| {errs[str(torch.float32)]:.3g}")
    torch.cuda.synchronize()
    print(f"K10 vs plain, largest |diff| with an f32 query over every case: {worst:.3g}")
    return serving_err


def prompts(n: int, vocab: int, lo: int, hi: int, seed: int = SEED) -> list[list[int]]:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=int(rng.integers(lo, hi + 1))).tolist()
            for _ in range(n)]


def serve(model, params, ecfg: EngineConfig, reqs_in, new: int):
    """Submit ``reqs_in`` (prompts) to a fresh engine and drain it; the
    launch counts and the serving histograms are reset just before.
    Returns (engine, requests, kernel launches, prefill and tick stats, wall s)."""
    obs_metrics.reset()
    eng = ServingEngine(model, params, ecfg)
    reqs = [Request(uid=i, prompt=list(p), max_new_tokens=new) for i, p in enumerate(reqs_in)]
    for r in reqs:
        eng.submit(r)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    done = eng.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    check(done.drained, f"serving ({ecfg.attention}) did not drain")
    check(all(len(r.out_tokens) == new for r in reqs),
          f"serving ({ecfg.attention}): a request ended short of {new} tokens")
    stats = {"prefill": obs_metrics.histogram("serving.prefill_s").percentiles(),
             "tick": obs_metrics.histogram("serving.tick_s").percentiles()}
    return eng, reqs, counts, stats, wall


class GatherCount:
    """Counts the calls of ``models.layers._gather_pages`` (the dense copy of
    a paged cache that K10's paged entry makes unneeded) while active."""

    def __enter__(self):
        self.n, self._orig = 0, model_layers._gather_pages

        def counted(*args):
            self.n += 1
            return self._orig(*args)

        model_layers._gather_pages = counted
        return self

    def __exit__(self, *exc):
        model_layers._gather_pages = self._orig


def serving_full_width(device) -> dict:
    """Phase 13: starcoder2-3b at its published widths through the engine."""
    cfg = registry.get_config(ARCH)
    model = registry.build_model(cfg)
    check(model.device.type == "cuda", "the default model device is not CUDA")
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(SEED)
    params = init_params(model.specs(), gen, device, torch.bfloat16)
    torch.cuda.synchronize()
    n_params = param_count(model.specs())
    print(f"{ARCH}: {n_params} parameters ({n_params * 2 / 1e9:.3f} GB bf16), "
          f"{cfg.n_layers} layers, d_model {cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads}, "
          f"init on the card {time.perf_counter() - t0:.2f} s")
    ps = prompts(SERVE_REQUESTS, cfg.vocab, *PROMPT_LEN)
    obs_metrics.enable()
    try:
        torch.cuda.reset_peak_memory_stats()
        with GatherCount() as gathers:
            eng, reqs, counts, stats, wall = serve(model, params, EngineConfig(**SERVE), ps,
                                                   SERVE_NEW)
        peak = torch.cuda.max_memory_allocated() / 2**30
        check(eng._fused, "attention='auto' did not pick K10 on the card")
        k10_n = counts["kvc_decode_attention"]
        check(k10_n == cfg.n_layers * eng.steps and k10_n > 0,
              f"K10 launched {k10_n} times in {eng.steps} decode steps of {cfg.n_layers} layers")
        # prefill attends through the plain path (4 gathers a layer); decode gathers nothing
        prefills = stats["prefill"]["count"]
        check(gathers.n == 4 * cfg.n_layers * prefills,
              f"{gathers.n} page gathers in {prefills} prefill calls and {eng.steps} decode "
              f"steps of {cfg.n_layers} layers: the fused decode path gathered pages")
        check(eng.check_kv_integrity(), "the KV pool is not clean after the drain")
        toks = [r.out_tokens for r in reqs]
        _, again, _, _, _ = serve(model, params, EngineConfig(**SERVE), ps, SERVE_NEW)
        check([r.out_tokens for r in again] == toks, "a second identical run gave other tokens")
        with GatherCount() as plain_gathers:
            plain_eng, plain, plain_counts, plain_stats, plain_wall = serve(
                model, params, EngineConfig(**SERVE, attention="xla"), ps, SERVE_NEW)
        check(plain_counts["kvc_decode_attention"] == 0, "attention='xla' launched K10")
        check(plain_gathers.n == 4 * cfg.n_layers * (plain_stats["prefill"]["count"]
                                                     + plain_eng.steps),
              f"the plain path gathered pages {plain_gathers.n} times")
        check(all(a.out_tokens[0] == b[0] for a, b in zip(plain, toks)),
              "first tokens (from prefill) differ between attention auto and xla")
        rest = [(a, b) for r, tk in zip(plain, toks) for a, b in zip(r.out_tokens[1:], tk[1:])]
        agree = sum(a == b for a, b in rest) / len(rest)
        profiled = tick_profile(model, params, ps)
    finally:
        obs_metrics.disable()
        obs_metrics.reset()
    pre, tick = stats["prefill"], stats["tick"]
    decode_s = tick["mean"] * tick["count"] - pre["mean"] * pre["count"]
    decode_tokens = SERVE_REQUESTS * (SERVE_NEW - 1)
    out = {"steps": eng.steps, "ticks": eng.ticks, "k10_launches": k10_n,
           "page_gathers": gathers.n, "xla_page_gathers": plain_gathers.n,
           "prefill_calls": pre["count"], "prefill_ms_mean": pre["mean"] * 1e3,
           "prefill_ms_max": pre["max"] * 1e3, "tick_ms_median": tick["p50"] * 1e3,
           "decode_tokens_per_s": decode_tokens / decode_s, "wall_s": wall,
           "pool_bytes": eng.pool.nbytes(), "pool_pages": eng.pool.n_pages,
           "peak_gib": peak, "xla_tick_ms_median": plain_stats["tick"]["p50"] * 1e3,
           "xla_wall_s": plain_wall, "xla_agree_after_first": agree,
           "prompt_tokens": sum(len(p) for p in ps)}
    print(f"serving {ARCH} full width (auto = K10): " + json.dumps(out))
    print("decode tick profile (8 live lanes): " + json.dumps(profiled))
    out["tokens"] = toks  # phase 22 holds the routed run to them
    del params, eng
    torch.cuda.empty_cache()
    return out


def on_device(tree, device):
    if isinstance(tree, dict):
        return {k: on_device(v, device) for k, v in tree.items()}
    return tree.to(device)


def tick_profile(model, params, ps, ticks: int = 5) -> dict:
    """Where a decode tick's time goes: ``torch.profiler`` over ``ticks``
    decode ticks of 8 live lanes (after the prompts' prefill), with the
    device's busy share (kernel time over wall) and the top kernels."""
    from torch.profiler import ProfilerActivity, profile

    eng = ServingEngine(model, params, EngineConfig(**SERVE))
    for i, p in enumerate(ps[:SERVE["batch_slots"]]):
        eng.submit(Request(uid=i, prompt=list(p), max_new_tokens=SERVE_NEW))
    eng.tick()  # admission, prefill and the first decode step
    eng.tick()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof, \
            GatherCount() as gathers:
        t0 = time.perf_counter()
        for _ in range(ticks):
            eng.tick()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    check(gathers.n == 0, f"{ticks} decode ticks gathered pages {gathers.n} times")
    events = [e for e in prof.key_averages() if e.device_time_total > 0
              and e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(e.device_time_total for e in events)
    top = sorted(events, key=lambda e: -e.device_time_total)[:10]
    out = {"tick_ms": wall / ticks * 1e3, "device_ms_per_tick": device_us / ticks / 1e3,
           "device_busy_share": device_us / 1e6 / wall,
           "kernel_launches_per_tick": sum(e.count for e in events) / ticks,
           "top_kernels_ms_per_tick": {e.key[:60]: e.device_time_total / ticks / 1e3 for e in top}}
    eng.drain_requests()
    return out


def serving_card_vs_cpu(device) -> None:
    """Phase 14: SMOKE config, same parameters and prompts, card (K10)
    against the CPU (K10's plain version)."""
    cfg = registry.get_config(ARCH, smoke=True)
    specs = registry.build_model(cfg, device="cpu").specs()
    params = init_params(specs, torch.Generator().manual_seed(SEED), "cpu", torch.bfloat16)
    ps = prompts(SMOKE_REQUESTS, cfg.vocab, 3, 20)
    toks = {}
    for dev, attention in ((device, "auto"), (torch.device("cpu"), "fused"),
                           (torch.device("cpu"), "xla")):
        model = registry.build_model(cfg, device=dev)
        eng = ServingEngine(model, on_device(params, dev), EngineConfig(
            batch_slots=2, max_len=64, codec="blockfloat8", paged=True, attention=attention))
        reqs = [Request(uid=i, prompt=list(p), max_new_tokens=SMOKE_NEW) for i, p in enumerate(ps)]
        for r in reqs:
            eng.submit(r)
        kernels.reset_launch_counts()
        check(eng.run_until_drained().drained, f"SMOKE serving on {dev.type} did not drain")
        n = kernels.launch_counts()["kvc_decode_attention"]
        check(n == (cfg.n_layers * eng.steps if dev.type == "cuda" else 0),
              f"SMOKE serving on {dev.type}: K10 launched {n} times")
        toks[f"{dev.type}-{attention}"] = [r.out_tokens for r in reqs]

    def agree(a, b):
        return [sum(x == y for x, y in zip(g, c)) for g, c in zip(toks[a], toks[b])]

    kernel_vs_plain = agree("cuda-auto", "cpu-fused")
    check(all(a >= 6 for a in kernel_vs_plain),
          f"card (K10) and CPU (plain K10) greedy tokens agree in {kernel_vs_plain} of 8")
    print(f"SMOKE serving card (K10) vs CPU (K10's plain version): tokens agree "
          f"{kernel_vs_plain} of {SMOKE_NEW}; vs the CPU's xla attention "
          f"{agree('cuda-auto', 'cpu-xla')} (bf16 attention logits there)")


def ptxas_resources(logs: dict[str, str]) -> dict[str, dict]:
    """Registers and spill bytes of K1, of each K10 instantiation
    (``kvc_attention_kernel<D>``) and of K6 and K7 from the build's
    ``-Xptxas=-v`` report; empty for a library that was not compiled in
    this run."""
    out, name = {}, None
    for log in logs.values():
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                k10m = re.search(r"kvc_attention_kernelILi(\d+)E", m.group(1))
                zfpm = re.search(r"zfp_fused_(?:en|de)code_kernel", m.group(1))
                name = (f"kvc_attention_kernel<{k10m.group(1)}>" if k10m else
                        zfpm.group(0) if zfpm else
                        "lorenzo3d_quantize_kernel" if "lorenzo3d_quantize_kernel" in m.group(1)
                        else None)
                if name:
                    out[name] = {}
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m and name:
                out[name]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m and name:
                out[name]["registers"] = int(m.group(1))
    return out


def k10_times(device, serving: dict, resources: dict) -> tuple[dict, dict]:
    """K10's paged entry (the main path's: the row of the report), its dense
    entry on the gathered cache, the paged plain version (gather + plain
    K10) and the library yardstick, at the serving shape and at S=32768,
    with the bound from this run's positions (and at full capacity), the
    share of the bound, and the main instantiation's registers and spills.
    Each is timed on the device from a CUDA graph (:func:`graph_ms`): K10's
    wrapper spends more host time per call than the kernel spends on the
    card, so an event pair around one direct call (``call_ms``, also
    printed) times the host."""
    rows = {}
    b, s0, h, hkv, d = KVC_SERVE_SHAPE
    n_rep = h // hkv
    for label, s, index in (("serving", s0, serving_index), ("decode_32k", KVC_LONG_S, long_index)):
        idx = index(b, s)
        q, kp, ksp, vp, vsp, table, ix = kvc_pool(b, s, h, hkv, d, torch.bfloat16, idx, device)
        kc, ks, vc, vs = (kref.gather_pages(t, table) for t in (kp, ksp, vp, vsp))  # untimed
        kd = (kc.float() * ks[..., None]).to(torch.bfloat16)  # dequantized beforehand, not timed
        vd = (vc.float() * vs[..., None]).to(torch.bfloat16)
        mask = (torch.arange(s, device=device)[None, :] <= ix[:, None])[:, None, None, :]

        def library():
            kr = kd.repeat_interleave(n_rep, dim=2).transpose(1, 2)
            vr = vd.repeat_interleave(n_rep, dim=2).transpose(1, 2)
            return F.scaled_dot_product_attention(q[:, :, None, :], kr, vr, attn_mask=mask)

        live = sum(min(i + 1, s) for i in idx if i >= 0)
        qo_bytes = 2 * 2 * b * h * d + 4 * b  # q and out in bf16, index
        table_bytes = 4 * table.numel()
        nbytes = live * hkv * (2 * d + 8) + qo_bytes + table_bytes

        def ops_ms(positions: int) -> float:
            """The function's arithmetic: the one scale per position and KV head
            factors out of q.k and p.v, so no dequantize pass; q.k of a bf16
            query with int8 codes is exact in bf16 (the tensor cores' rate),
            p.v stays f32; 2 D flops each per position and query head."""
            flops = positions * h * 2 * d
            return (flops / BF16_OPS_PER_S + flops / F32_OPS_PER_S) * 1e3

        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3

        def paged():
            return k10.kvc_decode_attention_paged(q, kp, ksp, vp, vsp, table, ix)

        def dense():
            return k10.kvc_decode_attention(q, kc, ks, vc, vs, ix)

        t = {"ms": graph_ms(paged), "dense_ms": graph_ms(dense),
             "plain_ms": graph_ms(lambda: kref.kvc_decode_attention_paged_ref(
                 q, kp, ksp, vp, vsp, table, ix), iters=PLAIN_ITERS),
             "library_ms": graph_ms(library), "call_ms": cuda_ms(paged, TIMING_ITERS),
             "dense_call_ms": cuda_ms(dense, TIMING_ITERS)}
        bound = max(bytes_ms, ops_ms(live))
        t.update(bytes_ms=bytes_ms, ops_ms=ops_ms(live), bound_ms=bound,
                 bound_by="bytes" if bytes_ms >= ops_ms(live) else "operations", positions=live,
                 share_of_bound=bound / t["ms"],
                 dense_share_of_bound=(bound - table_bytes / HBM_BYTES_PER_S * 1e3) / t["dense_ms"],
                 full_bytes_ms=(b * s * hkv * (2 * d + 8) + qo_bytes + table_bytes)
                 / HBM_BYTES_PER_S * 1e3, full_ops_ms=ops_ms(b * s),
                 splits=k10.split_plan(b, hkv, s, torch.cuda.get_device_properties(
                     device).multi_processor_count)[0],
                 **resources.get(f"kvc_attention_kernel<{d}>", {}))
        rows[label] = t
        del q, kp, ksp, vp, vsp, kc, ks, vc, vs, kd, vd
    torch.cuda.empty_cache()
    row = rows["serving"]
    row["tick_share"] = row["ms"] * registry.get_config(ARCH).n_layers / serving["tick_ms_median"]
    print("K10 times (ms, paged entry, dense entry on the gathered cache; bound from this run's "
          "positions and at full capacity; registers and spill bytes of the "
          f"kvc_attention_kernel<{d}> instantiation): " + json.dumps(rows))
    print(f"K10 share of a decode tick: {row['ms']:.4f} ms x 30 / "
          f"{serving['tick_ms_median']:.3f} ms = {row['tick_share']:.4f}")
    return row, rows["decode_32k"]


# ------------------------------------------------- Foresight and in-situ ----

FORESIGHT_RELS = (1e-2, 1e-3, 1e-4)  # SZ bounds x value range: CBench sweep and guideline
FORESIGHT_RATES = (4, 8)  # ZFP rates of the CBench sweep
HALO_GRID = 64  # hacc_particles grid of the halo gate: 262144 particles
HALO_RATES = (8, 16)
HOST_WORKERS = 6  # processes for the host-side analyses (FoF catalogs, P(k) gates)
FORESIGHT_OUT = Path(__file__).resolve().parent / "chip_smoke_out" / "foresight"  # gitignored
INSITU_DIR = SNAPSHOT_DIR / "insitu"  # gitignored; removed at the end
INSITU_AXES = ("pod", "data", "model")
INSITU_POD = 2  # ranks of the two-process group, (128, 256, 256) shards at 256^3
# labels of the in-situ runs: codec and sharded_compress keywords
INSITU_CASES = {"sz-core": ("sz", {}), "sz-kernel": ("sz", {"backend": "kernel"}),
                "zfp": ("zfp", {"rate": ZFP_RATE})}
INSITU_LAUNCHES = {"sz-core": {}, "sz-kernel": {"fused_compress": 1, "fused_decompress": 1},
                   "zfp": {"fused_compress_blocks": 1, "fused_decompress_blocks": 1}}
FORESIGHT_KERNELS = ("fused_compress", "fused_decompress", "fused_compress_blocks",
                     "fused_decompress_blocks")
EVENT_MBS: dict = {}  # (compressor, field) -> phase 3 / 7 ratio and event-timed MB/s


def host_timed(fn, *args, **kwargs):
    """``(fn(*args, **kwargs), its host seconds)``: run in the host pool."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    return out, time.perf_counter() - t0


def sz_configs(v) -> list[dict]:
    """The SZ configurations of the sweep: eb = rel x value range, as phase 3
    computes its bound (eb 1e-4 x range is phase 3's)."""
    return [{"eb": rel * float(v.max() - v.min())} for rel in FORESIGHT_RELS]


def read_counts(want: dict) -> dict[str, int]:
    """The launch counts of the path just driven, held to ``want`` exactly
    (kernels absent from ``want`` must not have launched)."""
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    got = {k: v for k, v in counts.items() if v}
    check(got == {k: v for k, v in want.items() if v},
          f"launches {got}, want {want}")
    return {k: counts[k] for k in FORESIGHT_KERNELS}


def cbench_sweep(fields: dict, device) -> tuple[dict, list]:
    """Foresight's CBench over the six 256^3 fields: tpu-sz at three bounds
    and tpu-zfp at two rates, warm-up 1 and 3 timed calls each way, so K3
    and K4 launch 72 times and K6 and K7 48."""
    spec = {"cases": [{"compressor": "tpu-sz", "fields": [name], "configs": sz_configs(v)}
                      for name, v in fields.items()]
            + [{"compressor": "tpu-zfp", "fields": list(fields),
                "configs": [{"rate": r} for r in FORESIGHT_RATES]}]}
    kernels.reset_launch_counts()
    rows = cbench.run_sweep(spec, fields, keep_reconstruction=True, device=device)
    n_sz, n_zfp = 6 * len(FORESIGHT_RELS), 6 * len(FORESIGHT_RATES)
    launches = read_counts({"fused_compress": 4 * n_sz, "fused_decompress": 4 * n_sz,
                            "fused_compress_blocks": 4 * n_zfp,
                            "fused_decompress_blocks": 4 * n_zfp})
    check(len(rows) == n_sz + n_zfp, f"{len(rows)} CBench rows")
    print("CBench (host perf_counter over 3 calls after 1 warm-up, each ended by "
          "torch.cuda.synchronize) beside phase 3 / 7's CUDA-event medians, MB/s:")
    for r in rows:
        ev = EVENT_MBS.get((r.compressor, r.field))
        if r.compressor == "tpu-sz":
            eb = r.config["eb"]
            check(r.max_abs_err <= eb * (1 + 1e-5), f"CBench {r.field} eb {eb}: max err "
                  f"{r.max_abs_err}")
            same_cfg = ev is not None and eb == ev["config"]["eb"]
        else:
            check(r.ratio == 32 / r.config["rate"], f"CBench ZFP ratio {r.ratio} at {r.config}")
            same_cfg = ev is not None and r.config["rate"] == ev["config"]["rate"]
        if same_cfg:
            check(r.ratio == ev["ratio"], f"CBench {r.compressor} {r.field} ratio {r.ratio} != "
                  f"the main path's {ev['ratio']}")
        event = (f"event compress={ev['compress']:.1f} decompress={ev['decompress']:.1f}"
                 if same_cfg else "event -")
        print(f"  {r.compressor:7s} {r.field:20s} {json.dumps(r.config):24s} ratio={r.ratio:.4f} "
              f"psnr={r.psnr:.4f}dB max_err={r.max_abs_err:.6g} cbench "
              f"compress={r.throughput_c_mbs:.1f} decompress={r.throughput_d_mbs:.1f} {event}")
    FORESIGHT_OUT.mkdir(parents=True, exist_ok=True)
    cbench.save_results(rows, FORESIGHT_OUT / "cbench.json")
    db = cinema.CinemaDatabase(FORESIGHT_OUT / "cinema_db", name="chip-smoke-cbench")
    for r in rows:
        db.add_case({k: v for k, v in r.row().items() if k != "config"} | {"config": str(r.config)})
    print(f"CBench rows and Cinema database written to {FORESIGHT_OUT} "
          f"({db.write().name}, {len(rows)} cases)")
    return launches, rows


def halo_recon(snap, comp, rate: int, device) -> tuple[np.ndarray, list]:
    """x, y, z through ``comp`` at ``rate``: the reconstructed positions
    and each coordinate's stream."""
    cols, parts = [], []
    for c in ("x", "y", "z"):
        v = torch.as_tensor(snap.fields[c], device=device)
        r = comp.compress(v, rate=rate)
        parts.append(r.payload["parts"][0])
        cols.append(comp.decompress(r).cpu().numpy())
    return np.stack(cols, axis=1), parts


def halo_start(pool, device) -> tuple[dict, dict]:
    """HACC positions through tpu-zfp on the card and on the CPU (bitwise
    equal), then the FoF catalogs and ``evaluate_gates`` handed to the host
    pool; :func:`halo_finish` reads them."""
    snap = cosmo.hacc_particles(grid=HALO_GRID)
    pos = snap.positions()
    gpu, cpu = get_compressor("tpu-zfp"), get_compressor("tpu-zfp", device="cpu")
    kernels.reset_launch_counts()
    card = {rate: halo_recon(snap, gpu, rate, device) for rate in HALO_RATES}
    n = 3 * len(HALO_RATES)
    launches = read_counts({"fused_compress_blocks": n, "fused_decompress_blocks": n})
    jobs = {"orig": pool.submit(host_timed, halos.fof_halos, pos, snap.box)}
    for rate in HALO_RATES:
        host, parts = halo_recon(snap, cpu, rate, "cpu")
        check(all(same_zfp(a, b) for a, b in zip(card[rate][1], parts)),
              f"halo gate rate {rate}: card and CPU streams differ")
        check(np.array_equal(card[rate][0].view(np.int32), host.view(np.int32)),
              f"halo gate rate {rate}: card and CPU reconstructions differ")
        jobs[("card", rate)] = pool.submit(host_timed, halos.fof_halos, card[rate][0], snap.box)
        jobs[("cpu", rate)] = pool.submit(host_timed, halos.fof_halos, host, snap.box)
        jobs[("gates", rate)] = pool.submit(host_timed, guideline.evaluate_gates, {}, {},
                                            particles=(pos, card[rate][0], snap.box))
    print(f"halo gate: hacc_particles(grid={HALO_GRID}) x, y, z ({len(pos)} particles) through "
          f"tpu-zfp at rates {HALO_RATES} on the card == on the CPU, bitwise; FoF on the host")
    return jobs, launches


def halo_finish(jobs: dict) -> None:
    t0 = time.perf_counter()
    results = {k: f.result() for k, f in jobs.items()}
    orig = results["orig"][0]
    for rate in HALO_RATES:
        card, host = results[("card", rate)][0], results[("cpu", rate)][0]
        check(np.array_equal(card.labels, host.labels) and np.array_equal(card.sizes, host.sizes)
              and card.n_halos == host.n_halos, f"halo catalogs of card and CPU differ at {rate}")
        ok, dev = halos.halo_gate(orig, card)
        passed, worst_pk, worst_halo = results[("gates", rate)][0]
        check(worst_halo == dev and worst_pk == 0.0 and passed == (dev <= 0.1),
              f"evaluate_gates at rate {rate}: {passed, worst_pk, worst_halo}, halo_gate {ok, dev}")
        print(f"halo gate rate {rate}: n_halos {card.n_halos} (original {orig.n_halos}), "
              f"worst halo deviation {worst_halo:.6f}, evaluate_gates passed={passed}")
    print(f"halo catalogs waited for {time.perf_counter() - t0:.2f} s after the guideline; "
          "host seconds (FoF in a pool process; evaluate_gates runs FoF twice): "
          + json.dumps({str(k): round(v[1], 3) for k, v in results.items()}))


def guideline_on_card(fields: dict, rows: list, pool, device) -> dict:
    """§V-D on the card: ``best_fit_per_field`` per 256^3 field over the
    three SZ bounds must pick the passing configuration with the highest
    ratio (the least-bad one where none passes), as the CBench sweep's
    reconstructions gated on the host say."""
    gates = {(r.field, r.config["eb"]): (r.ratio, pool.submit(host_timed, spectrum.pk_gate,
                                                              fields[r.field], r.reconstructed))
             for r in rows if r.compressor == "tpu-sz"}
    kernels.reset_launch_counts()
    picks = {name: guideline.best_fit_per_field({name: v}, "tpu-sz", sz_configs(v),
                                                device=device).field_results[name]
             for name, v in fields.items()}
    n = 6 * len(FORESIGHT_RELS)
    launches = read_counts({"fused_compress": 4 * n, "fused_decompress": 4 * n})
    for name, v in fields.items():
        cand = [(cfg, gates[(name, cfg["eb"])][0], gates[(name, cfg["eb"])][1].result()[0])
                for cfg in sz_configs(v)]
        passing = [c for c in cand if c[2][0]]
        want = (max(passing, key=lambda c: c[1]) if passing
                else min(cand, key=lambda c: c[2][1]))
        got = picks[name]
        check(got.config == want[0] and got.ratio == want[1] and got.passed == want[2][0]
              and got.worst_pk_dev == want[2][1],
              f"guideline {name}: picked {got.config} ({got.ratio}, {got.passed}), want {want}")
        print(f"guideline {name:20s} pick eb={got.config['eb']:.6g} ratio={got.ratio:.4f} "
              f"passed={got.passed} worst_pk_dev={got.worst_pk_dev:.6f} (gates: "
              + ", ".join(f"{c[1]:.3f}x {'PASS' if c[2][0] else 'fail'} {c[2][1]:.4f}"
                          for c in cand) + ")")
    pk_s = sorted(f.result()[1] for _ratio, f in gates.values())
    print(f"host pk_gate at {N}^3 in a pool process: median {statistics.median(pk_s):.3f} s "
          f"[{pk_s[0]:.3f}..{pk_s[-1]:.3f}] over {len(pk_s)}")
    return launches


def guideline_card_vs_cpu(small: dict, device) -> None:
    """The guideline at 64^3 on the card and on the CPU give the same picks
    and ratios.  The card's ``auto`` backend is the kernel and the CPU's the
    core coder, so the CPU run is pinned to the kernel backend's plain
    versions (the tests hold those to the JAX package)."""
    def fits(dev):
        return {name: guideline.best_fit_per_field({name: v}, "tpu-sz", sz_configs(v),
                                                   device=dev).field_results[name]
                for name, v in small.items()}

    card = fits(device)
    default = cbench.get_compressor
    cbench.get_compressor = lambda name, **kw: default(name, backend="kernel", **kw)
    try:
        host = fits("cpu")
    finally:
        cbench.get_compressor = default
    for name in small:
        a, b = card[name], host[name]
        check((a.config, a.ratio, a.passed, a.worst_pk_dev) == (b.config, b.ratio, b.passed,
                                                                b.worst_pk_dev),
              f"guideline {name} at {SMALL_N}^3: card {a} != CPU {b}")
    print(f"guideline at {SMALL_N}^3: card == CPU (kernel backend) picks and ratios, six fields")


def pat_workflow(device) -> dict:
    """The port's Foresight workflow example at n=64 on the card, locally,
    its SLURM submission script written beside the Cinema database."""
    path = Path(__file__).resolve().parent / "examples" / "torch_foresight_workflow.py"
    spec = importlib.util.spec_from_file_location("torch_foresight_workflow", path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    out = FORESIGHT_OUT / "workflow"
    kernels.reset_launch_counts()
    res = example.main(["--device", device.type, "--out", str(out), "--n", str(SMALL_N)])
    launches = read_counts({"fused_compress": 20, "fused_decompress": 20,
                            "fused_compress_blocks": 16, "fused_decompress_blocks": 16})
    sbatch = sorted(p.name for p in (out / "foresight-demo_jobs").glob("*.sbatch"))
    check((out / "submit_all.sh").is_file() and len(sbatch) == 4, f"SLURM scripts {sbatch}")
    check(len(res["spectra"]) == 9 and res["cinema"].is_file(), "workflow results")
    print(f"PAT workflow example on {device.type} at n={SMALL_N}: SLURM submission script and {sbatch} "
          f"written, {len(res['spectra'])} Cinema cases")
    return launches


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def insitu_start(base: np.ndarray, eb: float) -> list:
    """Start the two-process gloo groups (``pod`` = 2) on the card (both
    ranks on cuda:0: NCCL refuses two ranks on one device) and on the CPU;
    each rank runs :func:`insitu_worker` in a fresh process of this script."""
    shutil.rmtree(INSITU_DIR, ignore_errors=True)
    INSITU_DIR.mkdir(parents=True)
    np.save(INSITU_DIR / "field.npy", base)
    procs = []
    for dev in ("cuda", "cpu"):
        port = free_port()
        for rank in range(INSITU_POD):
            log = open(INSITU_DIR / f"{dev}_r{rank}.log", "w")
            procs.append(subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), "--insitu-rank", str(rank),
                 str(INSITU_POD), str(port), dev, str(INSITU_DIR), repr(eb)],
                stdout=log, stderr=subprocess.STDOUT))
    return procs


def insitu_worker(argv: list[str]) -> int:
    """One rank of a two-process group: its (128, 256, 256) shard of the
    256^3 baryon density through the three in-situ runs; writes its decoded
    shard, launch counts, bytes sent and (rank 0) the gathered host stream."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor

    rank, world, port, dev, out, eb = (int(argv[0]), int(argv[1]), argv[2], argv[3],
                                       Path(argv[4]), float(argv[5]))
    torch.set_num_threads(2)
    if dev == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world,
                            rank=rank)
    try:
        mesh = DeviceMesh(dev, torch.arange(world).reshape(world, 1, 1),
                          mesh_dim_names=INSITU_AXES)
        x = np.load(out / "field.npy", mmap_mode="r")
        spec = sharding.field_spec(x.shape, mesh)
        n = x.shape[0] // world
        local = torch.from_numpy(np.array(x[rank * n:(rank + 1) * n])).to(dev)
        field = DTensor.from_local(local, mesh, sharding.placements(spec, mesh), run_check=False,
                                   shape=x.shape, stride=(x.shape[1] * x.shape[2], x.shape[2], 1))
        res = {"spec": spec}
        for label, (codec, kw) in INSITU_CASES.items():
            kernels.reset_launch_counts()
            insitu.reset_sent_bytes()
            t0 = time.perf_counter()
            st = insitu.sharded_compress(field, codec, mesh, eb=eb if codec == "sz" else None,
                                         **kw)
            if dev == "cuda":
                torch.cuda.synchronize()
            t1 = time.perf_counter()
            y = insitu.sharded_decompress(st, mesh).to_local()
            if dev == "cuda":
                torch.cuda.synchronize()
            seconds = (t1 - t0, time.perf_counter() - t1)
            launches = {k: v for k, v in kernels.launch_counts().items() if v}
            ratio = insitu.compression_ratio(st)
            hss = insitu.to_host(st)
            np.save(out / f"{dev}_{label}_r{rank}.npy", y.cpu().numpy())
            res[label] = {"launches": launches, "sent": dict(insitu.sent_bytes), "ratio": ratio,
                          "position": st.position, "hss": hss, "seconds": seconds}
        with open(out / f"{dev}_r{rank}.pkl", "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()
    return 0


def same_hss(a, b) -> bool:
    if (a.codec, a.shape, a.local_shape, a.grid, a.halo, a.backend, a.params) != \
            (b.codec, b.shape, b.local_shape, b.grid, b.halo, b.backend, b.params):
        return False
    return all(ia == ib and sorted(ba) == sorted(bb)
               and all(np.array_equal(np.asarray(ba[k]), np.asarray(bb[k])) for k in ba)
               for (ia, ba), (ib, bb) in zip(a.shards, b.shards))


def insitu_one_rank(base: torch.Tensor, eb: float, device) -> tuple[dict, dict, dict]:
    """A one-rank NCCL group in this process: the 256^3 baryon density
    through ``sz`` core + halo, ``sz`` kernel and ``zfp`` kernel equals the
    single-device entry points, stream and decode; each kernel launches once
    per shard.  Returns the single-device decodes, the host streams and the
    launches."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}", world_size=1,
                            rank=0)
    try:
        mesh = init_device_mesh("cuda", (1, 1, 1), mesh_dim_names=INSITU_AXES)
        spec = sharding.field_spec(base.shape, mesh)
        single = {"sz-core": get_compressor("tpu-sz", backend="core"),
                  "sz-kernel": get_compressor("tpu-sz", backend="kernel"),
                  "zfp": get_compressor("tpu-zfp")}
        decodes, streams, total = {}, {}, dict.fromkeys(FORESIGHT_KERNELS, 0)
        for label, (codec, kw) in INSITU_CASES.items():
            comp = single[label]
            r = comp.compress(base, eb=eb) if codec == "sz" else comp.compress(base, **kw)
            decodes[label] = comp.decompress(r)
            kernels.reset_launch_counts()
            st = insitu.sharded_compress(base, codec, mesh, spec,
                                         eb=eb if codec == "sz" else None, **kw)
            y = insitu.sharded_decompress(st, mesh).to_local()
            for k, v in read_counts(INSITU_LAUNCHES[label]).items():
                total[k] += v
            if codec == "sz":
                p = r.payload["kpacked"] if label == "sz-kernel" else r.payload["parts"][0].packed
                check(same(st.words, p.words) and same(st.widths, p.widths)
                      and int(st.total_bits) == int(p.total_bits),
                      f"in-situ {label}: one-rank stream != the single-device entry point's")
            else:
                check(same_zfp(zfp_core.ZFPCompressed(st.words, st.emax, st.gtops, tuple(
                    base.shape), st.rate), r.payload["parts"][0]),
                    f"in-situ {label}: one-rank stream != the single-device entry point's")
            check(same(y, decodes[label]), f"in-situ {label}: one-rank decode != single-device")
            streams[label] = insitu.to_host(st)
        print("in-situ one-rank group (NCCL): sz core+halo, sz kernel and zfp kernel streams and "
              "decodes == the single-device entry points, bitwise; K3, K4, K6, K7 once each")
    finally:
        dist.destroy_process_group()
    return decodes, streams, total


def insitu_finish(procs: list, decodes: dict, one_rank: dict, device) -> dict:
    """Read the two-process groups: their gathered streams equal across card
    and CPU, each decoded shard and (every run) ``host_decode`` equal the
    single-device decode, each rank sends faces, scalars and its compressed
    payload only, and K3, K4, K6, K7 launch once per shard on the card.
    Then ``CheckpointManager`` saves and restores every host stream."""
    t0 = time.perf_counter()
    for p in procs:
        try:
            rc = p.wait(timeout=600)
        except subprocess.TimeoutExpired:
            p.kill()
            rc = "timeout"
        if rc != 0:
            logs = "\n".join(q.read_text()[-3000:] for q in sorted(INSITU_DIR.glob("*.log")))
            raise RuntimeError(f"chip_smoke check failed: in-situ rank exited {rc}\n{logs}")
    print(f"in-situ two-process groups waited for {time.perf_counter() - t0:.2f} s")
    res = {(dev, r): pickle.load(open(INSITU_DIR / f"{dev}_r{r}.pkl", "rb"))
           for dev in ("cuda", "cpu") for r in range(INSITU_POD)}
    total = dict.fromkeys(FORESIGHT_KERNELS, 0)
    n = decodes["sz-core"].shape[0] // INSITU_POD
    face = 4 * decodes["sz-core"].shape[1] * decodes["sz-core"].shape[2]
    for label, (codec, _kw) in INSITU_CASES.items():
        hss = {dev: res[(dev, 0)][label]["hss"] for dev in ("cuda", "cpu")}
        check(same_hss(hss["cuda"], hss["cpu"]), f"in-situ {label}: card and CPU streams differ")
        check(hss["cuda"].grid == (INSITU_POD, 1, 1), f"in-situ {label}: grid {hss['cuda'].grid}")
        for (dev, r), out in res.items():
            got = out[label]
            want = INSITU_LAUNCHES[label] if dev == "cuda" else {}
            check(got["launches"] == want, f"in-situ {label} {dev} rank {r}: {got['launches']}")
            for k, v in got["launches"].items():
                total[k] += v
            y = np.load(INSITU_DIR / f"{dev}_{label}_r{r}.npy")
            check(np.array_equal(y.view(np.int32),
                                 decodes[label][r * n:(r + 1) * n].cpu().numpy().view(np.int32)),
                  f"in-situ {label} {dev} rank {r}: decoded shard != single-device decode")
            blobs = hss["cuda"].shards[r][1]
            sent = {"ppermute": face * (1 + 1) * (r == 0) if label == "sz-core" else 0,
                    "all_reduce": (4 + 8) if codec == "sz" else 0,
                    "gather": sum(np.asarray(a).nbytes for a in blobs.values()) if r else 0,
                    "all_gather": 0}
            check(got["sent"] == sent and sum(sent.values()) < 4 * decodes[label][:n].numel(),
                  f"in-situ {label} {dev} rank {r}: sent {got['sent']}, want {sent}")
        check(same(insitu.host_decode(hss["cuda"], device=device), decodes[label]),
              f"in-situ {label}: host_decode != single-device decode")
        print(f"in-situ {label} two-process gloo ({INSITU_POD} x {hss['cuda'].local_shape}): "
              f"card == CPU streams, decodes == single-device, ratio "
              f"{res[('cuda', 0)][label]['ratio']:.4f}, bytes sent by rank 0 / 1: "
              f"{res[('cuda', 0)][label]['sent']} / {res[('cuda', 1)][label]['sent']}; "
              "host s (compress, decompress; first call of the process) card "
              + ", ".join(f"{res[('cuda', r)][label]['seconds'][0]:.4f}/"
                          f"{res[('cuda', r)][label]['seconds'][1]:.4f}" for r in range(INSITU_POD))
              + " CPU " + ", ".join(f"{res[('cpu', r)][label]['seconds'][0]:.4f}/"
                                    f"{res[('cpu', r)][label]['seconds'][1]:.4f}"
                                    for r in range(INSITU_POD)))
    mgr = ckpt.CheckpointManager(INSITU_DIR / "ckpt", async_save=False)
    state = {"one_rank": one_rank,
             "two_rank": {lb: res[("cuda", 0)][lb]["hss"] for lb in INSITU_CASES}}
    mgr.save(1, state)
    saved = mgr.last_result
    back, _ = mgr.restore(state_like=state)
    for group in ("one_rank", "two_rank"):
        for label in INSITU_CASES:
            check(same(back[group][label], decodes[label]),
                  f"in-situ {group} {label}: restored leaf != single-device decode")
    files = sorted(p.name for p in (INSITU_DIR / "ckpt" / "step_000000001").glob("leaf_*"))
    print(f"CheckpointManager saved {len(files)} insitu-* shard files (ratio "
          f"{saved.ratio:.4f}) and restored all six leaves on the card, bitwise")
    return total


# -------------------------------------- sharded snapshots and collectives ----

SHARDED_DIR = SNAPSHOT_DIR.parent / ".chip_smoke_sharded"  # gitignored; removed at the end
CHILD_PROCS: list = []  # the sharded pairs' rank processes, stopped at exit
# One absolute bound for every leaf, as the hook takes: |x|max / eb is at most
# 8e7 / 100 = 8e5 < 2^20 (vx), so no leaf leaves the guarded regime.
SHARDED_EB = 100.0
SHARDED_POD = 2
# snapshot_state's leaves on ("pod", "data", "model") = (2, 1, 1): each route
SHARDED_SPECS = {
    "['nyx']['baryon_density']": (), "['nyx']['dark_matter_density']": (),  # K8, first rank
    "['nyx']['temperature']": (None, "pod"),  # split on y: per-leaf route, K3 per shard
    **{f"['nyx']['{k}']": ("pod",) for k in ("vx", "vy", "vz")},  # flat arena, halo
    **{f"['hacc']['{k}']": ("pod",) for k in cosmo.HACC_FIELDS},  # flat arena, halo
    "['vx_ragged']": (), "['baryon64_bf16']": (),  # flat arena, axis None
}
RAW_LEAVES = [k for k in SHARDED_SPECS if k.startswith("['hacc']")] + ["['nyx']['temperature']"]
GRAD_BITS = (8, 4)
GRAD_STEPS = 3
GRAD_BLOCK = 1024
# launches per card rank (rank 0, rank 1) of: two hook snapshots (K8 once per
# kernel bucket on the first rank, K3 once per temperature shard), the
# restore of step 2 (K2 once per arena-szk row, K4 once per temperature
# shard), and the direct decode check (K8 timed once, K3 and K4 once)
SHARDED_LAUNCHES = {
    "hook": ({"fused_compress_batched": 2, "fused_compress": 2}, {"fused_compress": 2}),
    "restore": ({"lorenzo3d_reconstruct": 2, "fused_decompress": 2},) * 2,
    "direct": ({"fused_compress_batched": 1, "fused_compress": 1, "fused_decompress": 1},
               {"fused_compress": 1, "fused_decompress": 1}),
}
SHARDED_KERNELS = ("fused_compress_batched", "fused_compress", "fused_decompress",
                   "lorenzo3d_reconstruct")


def sharded_data(fields: dict, hacc, small: dict) -> None:
    """snapshot_state's leaves as .npy files for the rank processes (each
    takes its block of every leaf; the bf16 leaf is stored as its float32
    source)."""
    d = SHARDED_DIR / "data"
    shutil.rmtree(SHARDED_DIR, ignore_errors=True)
    d.mkdir(parents=True)
    for k, v in fields.items():
        np.save(d / f"nyx.{k}.npy", v)
    for k in cosmo.HACC_FIELDS:
        np.save(d / f"hacc.{k}.npy", hacc.fields[k])
    np.save(d / "vx_ragged.npy", np.ascontiguousarray(fields["vx"][:200, :130, :250]))
    np.save(d / "baryon64_bf16.npy", small["baryon_density"])


def _leaf_file(name: str) -> str:
    return ".".join(re.findall(r"\['([^']+)'\]", name)) + ".npy"


def sharded_start(dev: str) -> list:
    """A two-process gloo group (``pod`` = 2) on ``dev``: on the card both
    ranks on cuda:0 (NCCL refuses two ranks on one device).  Each rank runs
    :func:`sharded_worker` in a fresh process of this script."""
    port = free_port()
    procs = []
    for rank in range(SHARDED_POD):
        log = open(SHARDED_DIR / f"{dev}_r{rank}.log", "w")
        procs.append(subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--sharded-rank", str(rank),
             str(SHARDED_POD), str(port), dev, str(SHARDED_DIR)],
            stdout=log, stderr=subprocess.STDOUT))
    CHILD_PROCS.extend(procs)
    return procs


def digest(t: torch.Tensor) -> str:
    import hashlib

    return hashlib.sha256(t.detach().cpu().contiguous().reshape(-1).view(torch.uint8)
                          .numpy().tobytes()).hexdigest()


def tree_digest(tree: dict) -> str:
    return "".join(digest(tree[k]) for k in sorted(tree))


def block_grad_shapes() -> dict:
    """One starcoder2-3b block's parameter shapes at its published widths
    (d_model 3072, 24 / 2 heads of 128, d_ff 12288): the gradient tree."""
    specs = registry.build_model(registry.get_config(ARCH), device="cpu").specs()["layers"]
    return {f"{g}.{k}": tuple(v.shape[1:]) for g, sub in specs.items() for k, v in sub.items()}


def block_grads(shapes: dict, rank: int) -> dict:
    gen = torch.Generator().manual_seed(SEED + rank)
    return {k: torch.randn(s, generator=gen) * 1e-3 for k, s in shapes.items()}


def hook_layout(mesh, named: dict):
    """The hook's payload groups for ``named`` (the plan it makes):
    ``{field key: spec per leaf name}``."""
    entries = [(k, tuple(v.shape), v.dtype, sharding.spec_of(v)) for k, v in named.items()]
    kb, rest = insitu.plan_kernel_buckets(entries, mesh)
    fb, skipped = insitu.plan_arena(rest, mesh)
    out = {f"karena{k:03d}": {n: () for n in b.names} for k, b in enumerate(kb)}
    out.update({f"arena{k:03d}": {n: SHARDED_SPECS[n] for n in b.names} for k, b in enumerate(fb)})
    out.update({k: SHARDED_SPECS[k] for k, _ in skipped})
    return kb, fb, out


def shardings_for(layout: dict, mesh):
    return {k: ({n: sharding.NamedSharding(mesh, sp) for n, sp in v.items()} if isinstance(v, dict)
                else sharding.NamedSharding(mesh, v)) for k, v in layout.items()}


def local_digests(restored: dict) -> dict:
    out = {}
    for k, v in restored.items():
        for n, t in (v.items() if isinstance(v, dict) else [(k, v)]):
            out[n] = digest(t.to_local())
    return out


def sync(dev) -> None:
    if str(dev).startswith("cuda"):
        torch.cuda.synchronize()


def stacked(v: torch.Tensor, mesh, world: int):
    """This rank's pod gradient as its row of a ``(world, *shape)``
    ``DTensor`` split on dim 0 over ``pod``."""
    from torch.distributed.tensor import DTensor

    shape = (world,) + tuple(v.shape)
    return DTensor.from_local(v[None], mesh, sharding.placements(("pod",), mesh),
                              run_check=False, shape=shape,
                              stride=torch.empty(shape, device="meta").stride())


def sharded_worker(argv: list[str]) -> int:
    """One rank of a two-process group: snapshot_state's leaves placed on
    ("pod", "data", "model") = (2, 1, 1) through the in-situ hook (two
    snapshots in flight, restore with ``shardings``), the raw DTensor saves
    and the compressed cross-pod gradient mean; writes its counts, bytes
    sent, times and digests."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.dist import collectives
    from repro_torch.launch.train import build_insitu_hook

    t_start = time.perf_counter()
    rank, world, port, dev, out = (int(argv[0]), int(argv[1]), argv[2], argv[3], Path(argv[4]))
    torch.set_num_threads(2)
    card = dev == "cuda"
    if card:
        torch.cuda.set_device(0)
    # the pairs run beside other phases on the host's idle cycles: the main
    # process's host work (P(k), FoF, the guideline) goes first
    os.nice(10)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world,
                            rank=rank)
    res = {}
    try:
        mesh = DeviceMesh(dev, torch.arange(world).reshape(world, 1, 1), mesh_dim_names=INSITU_AXES)
        named = {}
        for k, spec in SHARDED_SPECS.items():
            x = torch.from_numpy(np.load(out / "data" / _leaf_file(k)))
            if k == "['baryon64_bf16']":
                x = x.to(torch.bfloat16)
            named[k] = sharding.place(x, sharding.NamedSharding(mesh, spec))
        state = {"nyx": {k[9:-2]: v for k, v in named.items() if k.startswith("['nyx']")},
                 "hacc": {k[10:-2]: v for k, v in named.items() if k.startswith("['hacc']")},
                 "vx_ragged": named["['vx_ragged']"], "baryon64_bf16": named["['baryon64_bf16']"]}
        kb, fb, layout = hook_layout(mesh, named)
        first = rank == 0

        # the hook: two snapshots, the second taken while the first drains
        hook = build_insitu_hook(mesh, str(out / f"{dev}_hook"), SHARDED_EB, min_bytes=1 << 16,
                                 overlap=True, slots=2, backend="kernel")
        sync(dev)
        kernels.reset_launch_counts()
        insitu.reset_sent_bytes()
        t0 = time.perf_counter()
        hook(1, state)
        t1 = time.perf_counter()
        hook(2, state)
        t2 = time.perf_counter()
        hook.wait()
        sync(dev)
        t3 = time.perf_counter()
        res["hook"] = {"launches": {k: v for k, v in kernels.launch_counts().items() if v},
                       "sent": dict(insitu.sent_bytes),
                       "stall_ms": [(t1 - t0) * 1e3, (t2 - t1) * 1e3], "wall_ms": (t3 - t0) * 1e3,
                       "ratio": hook.manager.last_result.ratio if first else None}
        dist.barrier()

        if card:  # the CPU pair owes its files only (equal to the card pair's)
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            back, _ = hook.manager.restore(step=2, state_like=dict.fromkeys(layout, 0),
                                           shardings=shardings_for(layout, mesh))
            sync(dev)
            res["restore"] = {"ms": (time.perf_counter() - t0) * 1e3,
                              "launches": {k: v for k, v in kernels.launch_counts().items() if v},
                              "digests": local_digests(back)}
            errs = {}
            for key, v in back.items():
                for n, t in (v.items() if isinstance(v, dict) else [(key, v)]):
                    x = named[n].to_local().float()
                    errs[n] = (float((t.to_local().float() - x).abs().max()), float(x.abs().max()))
            res["restore"]["errs"] = errs
            del back

            # each bucket's compress on its own (ms), and the decoded DTensor leaves
            kernels.reset_launch_counts()
            times, decoded = {}, {}
            for k, b in enumerate(kb if first else []):
                sync(dev)
                t0 = time.perf_counter()
                arena.szk_compress_bucket([named[n].to_local() for n in b.names], b, SHARDED_EB,
                                          device=dev)
                sync(dev)
                times[f"karena{k:03d} (K8, {b.rows} rows)"] = (time.perf_counter() - t0) * 1e3
            for k, b in enumerate(fb):
                if b.axis is None and not first:
                    continue
                sync(dev)
                t0 = time.perf_counter()
                st = insitu.sharded_compress_arena([named[n] for n in b.names], b, mesh, SHARDED_EB)
                sync(dev)
                times[f"arena{k:03d} ({b.rows} rows, axis {b.axis})"] = (time.perf_counter() - t0) * 1e3
                for n, y in zip(b.names, insitu.sharded_decompress_arena(st, mesh)):
                    decoded[n] = digest(y.to_local())
            sync(dev)
            t0 = time.perf_counter()
            st = insitu.sharded_compress(named["['nyx']['temperature']"], "sz", mesh, eb=SHARDED_EB,
                                         backend="kernel")
            sync(dev)
            times["['nyx']['temperature'] (per leaf, K3)"] = (time.perf_counter() - t0) * 1e3
            decoded["['nyx']['temperature']"] = digest(insitu.sharded_decompress(st, mesh).to_local())
            sync(dev)
            res["direct"] = {"ms": times, "digests": decoded,
                             "launches": {k: v for k, v in kernels.launch_counts().items() if v}}

        # raw DTensor leaves, lossless and lossy, saved per shard and restored
        raw = {"hacc": state["hacc"], "temperature": state["nyx"]["temperature"]}
        raw_sh = {"hacc": {k: sharding.NamedSharding(mesh, ("pod",)) for k in raw["hacc"]},
                  "temperature": sharding.NamedSharding(mesh, (None, "pod"))}
        for label, pol in (("lossless", ckpt.CodecPolicy(zstd_level=0)),
                           ("lossy", ckpt.CodecPolicy(mode="sz_abs", eb=SHARDED_EB,
                                                      min_bytes=1 << 16, zstd_level=0))):
            mgr = ckpt.CheckpointManager(out / f"{dev}_raw_{label}", async_save=True, device=dev,
                                         policy=pol)
            insitu.reset_sent_bytes()
            t0 = time.perf_counter()
            mgr.save(1, raw)
            t1 = time.perf_counter()
            mgr.wait()
            t2 = time.perf_counter()
            sent = dict(insitu.sent_bytes)
            dist.barrier()
            res[f"raw_{label}"] = {"stall_ms": (t1 - t0) * 1e3, "drain_ms": (t2 - t0) * 1e3,
                                   "sent": sent}
            if not card:
                continue
            t0 = time.perf_counter()
            got, _ = mgr.restore(step=1, state_like={"hacc": dict.fromkeys(raw["hacc"], 0),
                                                     "temperature": 0}, shardings=raw_sh)
            sync(dev)
            flat_got = {f"['hacc']['{k}']": v for k, v in got["hacc"].items()}
            flat_got["['nyx']['temperature']"] = got["temperature"]
            res[f"raw_{label}"].update(
                restore_ms=(time.perf_counter() - t0) * 1e3,
                errs={n: float((t.to_local() - named[n].to_local()).abs().max())
                      for n, t in flat_got.items()},
                digests={n: digest(t.to_local()) for n, t in flat_got.items()})
            del got, flat_got

        # the compressed cross-pod gradient mean over one block's gradients
        shapes = block_grad_shapes()
        grads = {k: v.to(dev) for k, v in block_grads(shapes, rank).items()}
        other = block_grads(shapes, 1 - rank)
        plain = {k: (grads[k] + other[k].to(dev)) / 2 for k in grads}  # two terms: either order
        del other
        hops = {}
        for form in ("pod_mean", "stacked"):
            for bits in GRAD_BITS:
                cfg = collectives.GradCompressionConfig(enabled=True, bits=bits, block=GRAD_BLOCK)
                ef = {k: torch.zeros(s, dtype=torch.bfloat16, device=dev) for k, s in shapes.items()}
                if form == "stacked":
                    ef = {k: sharding.place(torch.zeros((world,) + s, dtype=torch.bfloat16),
                                            sharding.NamedSharding(mesh, ("pod",)))
                          for k, s in shapes.items()}
                for step in range(GRAD_STEPS):
                    g = {k: v * (step + 1) for k, v in grads.items()}
                    if form == "stacked":
                        g = {k: stacked(v, mesh, world) for k, v in g.items()}
                    insitu.reset_sent_bytes()
                    sync(dev)
                    t0 = time.perf_counter()
                    if form == "pod_mean":
                        mean, ef = collectives.compressed_pod_mean(g, cfg, ef, mesh=mesh)
                    else:
                        mean, ef = collectives.compressed_pod_mean_stacked(g, cfg, ef, mesh)
                    sync(dev)
                    ms = (time.perf_counter() - t0) * 1e3
                    efl = {k: (v.to_local() if form == "stacked" else v) for k, v in ef.items()}
                    hops[(form, bits, step)] = {"ms": ms, "sent": dict(insitu.sent_bytes),
                                                "mean": tree_digest(mean), "ef": tree_digest(efl)}
                    del g, mean
            off = collectives.GradCompressionConfig(enabled=False)
            g = grads if form == "pod_mean" else {k: stacked(v, mesh, world)
                                                  for k, v in grads.items()}
            sync(dev)
            t0 = time.perf_counter()
            mean, none = (collectives.compressed_pod_mean(g, off, None, mesh=mesh)
                          if form == "pod_mean" else
                          collectives.compressed_pod_mean_stacked(g, off, None, mesh))
            sync(dev)
            hops[(form, "off")] = {"ms": (time.perf_counter() - t0) * 1e3,
                                   "plain": all(torch.equal(mean[k], plain[k]) for k in plain)
                                   and none is None, "mean": tree_digest(mean)}
            del mean, g
        res["grads"] = {"hops": hops, "n_params": sum(math.prod(s) for s in shapes.values()),
                        "shapes": shapes}
        res["seconds"] = time.perf_counter() - t_start
        with open(out / f"{dev}_r{rank}.pkl", "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()
    return 0


def wait_procs(procs: list, logs_glob: str, label: str) -> None:
    for p in procs:
        try:
            rc = p.wait(timeout=900)
        except subprocess.TimeoutExpired:
            p.kill()
            rc = "timeout"
        if rc != 0:
            logs = "\n".join(q.read_text()[-3000:] for q in sorted(SHARDED_DIR.glob(logs_glob)))
            raise RuntimeError(f"chip_smoke check failed: {label} rank exited {rc}\n{logs}")


def same_dir(a: Path, b: Path) -> list:
    """The files of two step directories byte for byte (observatory
    records hold timings): returns the names."""
    names = sorted(p.name for p in a.iterdir() if not p.name.startswith("obs_"))
    check(names == sorted(p.name for p in b.iterdir() if not p.name.startswith("obs_")),
          f"{a} and {b} hold other files")
    for n in names:
        check((a / n).read_bytes() == (b / n).read_bytes(), f"{a.name}/{n} differs: {a} vs {b}")
    return names


def rank_gather_bytes(step_dir: Path, shard: int) -> int:
    """The bytes the hook's rank ``shard`` gathered to the first rank for
    one step: its split arena slabs and sidecars and its per-leaf stream."""
    manifest = json.loads((step_dir / "MANIFEST.json").read_text())
    mgr = ckpt.CheckpointManager(step_dir.parent, async_save=False, device="cpu")
    total = 0
    for i, leaf in enumerate(manifest["leaves"]):
        if len(leaf.get("shards", [])) <= shard:
            continue
        prefix = "arena" if leaf["codec"].startswith("arena-") else "leaf"
        name = f"{prefix}_{i:05d}_s{shard:03d}.bin"
        blobs = arena.payload_decode(mgr._read_payload(step_dir, name, leaf["shards"][shard], 0))
        total += sum(np.asarray(a).nbytes for a in blobs.values())
    return total


def raw_rank1_bytes(step_dir: Path) -> int:
    """What the second rank of a raw split save sends: the payloads of
    the shards it holds (those not starting at 0 on the split dim)."""
    manifest = json.loads((step_dir / "MANIFEST.json").read_text())
    return sum(sh["stored_bytes"] for leaf in manifest["leaves"] for sh in leaf.get("shards", [])
               if any(start > 0 for start, _stop in sh["index"]))


def sharded_references(fields: dict, hacc, small: dict, device) -> dict:
    """Each hook leaf decoded by the reference semantics on one device:
    flat leaves through ``sz.compress`` / ``sz.decompress`` of the whole flat
    leaf, K8 rows as the one-field fused stream, the per-leaf route as
    single-device ``sz`` with the kernel backend."""
    src = {**{f"['nyx']['{k}']": v for k, v in fields.items()},
           **{f"['hacc']['{k}']": hacc.fields[k] for k in cosmo.HACC_FIELDS},
           "['vx_ragged']": np.ascontiguousarray(fields["vx"][:200, :130, :250]),
           "['baryon64_bf16']": small["baryon_density"]}
    out = {}
    for n, spec in SHARDED_SPECS.items():
        x = torch.from_numpy(src[n]).to(device)
        if n == "['baryon64_bf16']":
            x = x.to(torch.bfloat16)
        if n == "['nyx']['temperature']":
            comp = get_compressor("tpu-sz", backend="kernel", device=device)
            y = comp.decompress(comp.compress(x, eb=SHARDED_EB))
        elif spec == () and x.ndim == 3 and not any(s % t for s, t in zip(x.shape, lor.TILE)):
            packed, padded, eb_i = ops.sz_compress_kernel(x, SHARDED_EB)
            y = ops.sz_decompress_kernel(packed, padded, x.shape, eb_i, path="fused")
        else:
            flat = x.float().reshape(-1)
            y = sz_core.decompress(sz_core.compress(flat, SHARDED_EB)).reshape(x.shape).to(x.dtype)
        out[n] = (x.cpu(), y.cpu(), spec)
    return out


def split_digests(y: torch.Tensor, spec: tuple) -> list:
    """The digest of each rank's block of ``y`` under ``spec`` (pod = 2)."""
    if not spec:
        return [digest(y)] * SHARDED_POD
    d = spec.index("pod")
    return [digest(c) for c in torch.chunk(y, SHARDED_POD, dim=d)]


def sharded_finish(procs: dict, fields: dict, hacc, small: dict, device) -> dict:
    """Phase 16: read the card and CPU pairs, hold them to each other and
    to the reference semantics, restore every directory onto a one-rank
    NCCL mesh here (another mesh than the pair's), and run the gradient hop
    on that group.  Returns the phase's K8, K3, K4 and K2 launches."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.dist import collectives

    t0 = time.perf_counter()
    for dev, ps in procs.items():
        wait_procs(ps, f"{dev}_r*.log", f"sharded {dev}")
    res = {(dev, r): pickle.load(open(SHARDED_DIR / f"{dev}_r{r}.pkl", "rb"))
           for dev in ("cuda", "cpu") for r in range(SHARDED_POD)}
    print(f"sharded pairs waited for {time.perf_counter() - t0:.2f} s; each rank's own wall s "
          "(process start to its last hop): " + json.dumps(
              {f"{d} {r}": round(v["seconds"], 2) for (d, r), v in res.items()}))
    total = dict.fromkeys(SHARDED_KERNELS, 0)

    # files: the card pair's equal the CPU pair's, byte for byte
    names = []
    for sub in ("hook/step_000000001", "hook/step_000000002", "raw_lossless/step_000000001",
                "raw_lossy/step_000000001"):
        a, b = sub.split("/")
        names += same_dir(SHARDED_DIR / f"cuda_{a}" / b, SHARDED_DIR / f"cpu_{a}" / b)
    print(f"sharded phase: {len(names)} files of the card pair == the CPU pair's, byte for byte")

    # launches per rank, exactly; bytes sent per rank, exactly
    hook_dir = SHARDED_DIR / "cuda_hook"
    gathered = sum(rank_gather_bytes(hook_dir / f"step_00000000{s}", 1) for s in (1, 2))
    kb_rows = 6 + 3  # the two split flat buckets' rows (HACC 6, velocities 3)
    for (dev, r), out in res.items():
        for part in ("hook", "restore", "direct") if dev == "cuda" else ("hook",):
            want = SHARDED_LAUNCHES[part][r] if dev == "cuda" else {}
            check(out[part]["launches"] == want, f"sharded {part} {dev} rank {r}: launches "
                  f"{out[part]['launches']}, want {want}")
            if dev == "cuda":
                for k, v in out[part]["launches"].items():
                    total[k] += v
        sent = {"ppermute": 2 * 4 * kb_rows if r == 0 else 0,
                "all_reduce": 2 * (4 * kb_rows + 4), "gather": gathered if r else 0,
                "all_gather": 0}
        check(out["hook"]["sent"] == sent, f"sharded hook {dev} rank {r}: sent "
              f"{out['hook']['sent']}, want {sent}")
        for label in ("raw_lossless", "raw_lossy"):
            got = out[label]["sent"]
            check({k: v for k, v in got.items() if k != "gather"}
                  == {"ppermute": 0, "all_reduce": 0, "all_gather": 0}
                  and got["gather"] == (raw_rank1_bytes(
                      SHARDED_DIR / f"cuda_{label}" / "step_000000001") if r else 0),
                  f"{label} {dev} rank {r}: sent {got}")
        if dev != "cuda":
            continue
        for n, (err, amax) in out["restore"]["errs"].items():
            # a bfloat16 leaf holds its decode rounded to bfloat16: half an ulp more
            slack = amax * 2.0**-8 if n == "['baryon64_bf16']" else 0.0
            check(err <= SHARDED_EB * (1 + 1e-5) + slack,
                  f"sharded restore {dev} rank {r}: {n} max err {err} > eb {SHARDED_EB}")

    # every decode against the reference semantics, bitwise (digests of blocks)
    refs = sharded_references(fields, hacc, small, device)
    for r in range(SHARDED_POD):
        dev, out = "cuda", res[("cuda", r)]
        for n, (_x, y, spec) in refs.items():
            want = split_digests(y, spec)[r]
            check(out["restore"]["digests"][n] == want,
                  f"sharded restore {dev} rank {r}: {n} != the reference decode")
            if n in out["direct"]["digests"]:
                check(out["direct"]["digests"][n] == want,
                      f"sharded decode {dev} rank {r}: {n} != the reference decode")
        for label in ("raw_lossless", "raw_lossy"):
            for n, e in out[label]["errs"].items():
                check(e == 0.0 if label == "raw_lossless" else e <= SHARDED_EB * (1 + 1e-5),
                      f"{label} {dev} rank {r}: {n} max err {e}")

    # the gradient hop: card == CPU bitwise, wire bytes exactly codes + scales
    shapes = res[("cuda", 0)]["grads"]["shapes"]
    for r in range(SHARDED_POD):
        card, host = res[("cuda", r)]["grads"]["hops"], res[("cpu", r)]["grads"]["hops"]
        for key, h in card.items():
            if key[-1] == "off":
                check(h["plain"] and host[key]["plain"] and h["mean"] == host[key]["mean"],
                      f"gradient hop {key} rank {r}: enabled=False != the plain mean")
                continue
            bits = key[1]
            wire = sum(-(-math.prod(s) // GRAD_BLOCK) * (GRAD_BLOCK * bits // 8 + 4)
                       for s in shapes.values())
            check(h["mean"] == host[key]["mean"] and h["ef"] == host[key]["ef"],
                  f"gradient hop {key} rank {r}: card and CPU means or error feedback differ")
            check(h["sent"] == {"ppermute": 0, "all_reduce": 0, "gather": 0, "all_gather": wire},
                  f"gradient hop {key} rank {r}: sent {h['sent']}, want {wire} codes + scales")

    # restore on a one-rank NCCL mesh here, and the hop on its group
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}", world_size=1,
                            rank=0)
    try:
        mesh = init_device_mesh("cuda", (1, 1, 1), mesh_dim_names=INSITU_AXES)
        named = {n: x for n, (x, _y, _s) in refs.items()}
        placed = {n: sharding.place(x, sharding.NamedSharding(mesh, SHARDED_SPECS[n]))
                  for n, x in named.items()}
        # the pair's plan (its mesh's axis sizes), placed on this mesh
        _kb, _fb, layout2 = hook_layout(
            types.SimpleNamespace(shape=(SHARDED_POD, 1, 1), mesh_dim_names=INSITU_AXES), placed)
        mgr = ckpt.CheckpointManager(hook_dir, async_save=False)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        back, _ = mgr.restore(step=2, state_like=dict.fromkeys(layout2, 0),
                              shardings=shardings_for(layout2, mesh))
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
        want = {"lorenzo3d_reconstruct": 2, "fused_decompress": 2}
        got = {k: v for k, v in kernels.launch_counts().items() if v}
        check(got == want, f"one-rank restore launches {got}, want {want}")
        for k, v in got.items():
            total[k] += v
        for key, v in back.items():
            for n, t in (v.items() if isinstance(v, dict) else [(key, v)]):
                check(same(t.to_local(), refs[n][1]), f"one-rank restore of {n} != the reference")
        for label in ("lossless", "lossy"):
            m = ckpt.CheckpointManager(SHARDED_DIR / f"cuda_raw_{label}", async_save=False)
            got, _ = m.restore(step=1, state_like={"hacc": dict.fromkeys(cosmo.HACC_FIELDS, 0),
                                                   "temperature": 0},
                               shardings=sharding.NamedSharding(mesh, ("pod",)))
            for k, t in list(got["hacc"].items()) + [("temperature", got["temperature"])]:
                n = f"['hacc']['{k}']" if k != "temperature" else "['nyx']['temperature']"
                err = float((t.to_local() - named[n].to(t.device)).abs().max())
                check(err == 0.0 if label == "lossless" else err <= SHARDED_EB * (1 + 1e-5),
                      f"one-rank restore of raw {label} {n}: max err {err}")
                halves = torch.chunk(t.to_local(), SHARDED_POD, dim=SHARDED_SPECS[n].index("pod"))
                check([digest(h) for h in halves] == [res[("cuda", r)][f"raw_{label}"]["digests"][n]
                                                      for r in range(SHARDED_POD)],
                      f"one-rank restore of raw {label} {n} != the pair's restore")
        del back, got
        grads = {k: v.to(device) for k, v in block_grads(shapes, 0).items()}
        nccl = {}
        for bits in GRAD_BITS:
            cfg = collectives.GradCompressionConfig(enabled=True, bits=bits, block=GRAD_BLOCK)
            ef = {k: torch.zeros(s, dtype=torch.bfloat16, device=device) for k, s in shapes.items()}
            ms = []
            for step in range(GRAD_STEPS):
                g = {k: v * (step + 1) for k, v in grads.items()}
                want_ef = {}
                for k, v in g.items():
                    carry = v.reshape(-1) + ef[k].reshape(-1).float()
                    c, sc = collectives._quantize_blockwise(carry, bits, GRAD_BLOCK)
                    own = collectives._dequantize_blockwise(c, sc, carry.numel(), GRAD_BLOCK)
                    want_ef[k] = (carry - own, own)
                insitu.reset_sent_bytes()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                mean, ef = collectives.compressed_pod_mean(g, cfg, ef, mesh=mesh)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                for k in g:
                    check(same(mean[k].reshape(-1), want_ef[k][1]) and same(
                        ef[k].reshape(-1), want_ef[k][0].to(torch.bfloat16)),
                        f"one-rank NCCL hop bits {bits} step {step}: {k}")
            nccl[bits] = ms
        off = collectives.GradCompressionConfig(enabled=False)
        ms_off = []
        for _ in range(GRAD_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mean, _ = collectives.compressed_pod_mean(grads, off, None, mesh=mesh)
            torch.cuda.synchronize()
            ms_off.append((time.perf_counter() - t0) * 1e3)
        check(all(same(mean[k], grads[k]) for k in grads), "one-rank NCCL enabled=False != mean")
        del grads, mean, g, ef
    finally:
        dist.destroy_process_group()

    card = card_line()
    r0, r1 = res[("cuda", 0)], res[("cuda", 1)]
    print(f"sharded snapshot (card pair, {SHARDED_POD} gloo ranks on cuda:0, eb {SHARDED_EB}; "
          f"{card}): ratio {r0['hook']['ratio']:.4f}; save() stalls ms rank 0 "
          f"{[round(v, 3) for v in r0['hook']['stall_ms']]}, rank 1 "
          f"{[round(v, 3) for v in r1['hook']['stall_ms']]}; drain wall ms "
          f"{r0['hook']['wall_ms']:.3f} / {r1['hook']['wall_ms']:.3f}; restore on the pair ms "
          f"{r0['restore']['ms']:.3f} / {r1['restore']['ms']:.3f}, on one NCCL rank "
          f"{restore_ms:.3f}; bytes sent by kind rank 0 {r0['hook']['sent']}, rank 1 "
          f"{r1['hook']['sent']} (no raw field)")
    for r in range(SHARDED_POD):
        print(f"  rank {r} bucket compress ms (card): " + json.dumps(
            {k: round(v, 3) for k, v in res[("cuda", r)]["direct"]["ms"].items()}))
        for label in ("raw_lossless", "raw_lossy"):
            o = res[("cuda", r)][label]
            print(f"  rank {r} {label}: stall {o['stall_ms']:.3f} ms, drain {o['drain_ms']:.3f} ms, "
                  f"restore {o['restore_ms']:.3f} ms, sent {o['sent']}")
    n_params = r0["grads"]["n_params"]
    print(f"gradient hop ({ARCH} block, {n_params} params, {4 * n_params / 1e6:.1f} MB f32 per "
          f"rank, block {GRAD_BLOCK}, 3 steps; {card}), ms per step:")
    for form in ("pod_mean", "stacked"):
        for bits in GRAD_BITS:
            print(f"  {form} bits {bits}: gloo pair rank 0 "
                  f"{[round(r0['grads']['hops'][(form, bits, s)]['ms'], 3) for s in range(GRAD_STEPS)]}"
                  f", wire {r0['grads']['hops'][(form, bits, 0)]['sent']['all_gather']} B per rank")
        print(f"  {form} enabled=False (all_reduce mean): gloo pair rank 0 "
              f"{r0['grads']['hops'][(form, 'off')]['ms']:.3f}")
    print(f"  one-rank NCCL pod_mean ms: bits 8 {[round(v, 3) for v in nccl[8]]}, bits 4 "
          f"{[round(v, 3) for v in nccl[4]]}, enabled=False {[round(v, 3) for v in ms_off]}")
    print("sharded phase launches: " + json.dumps(total))
    return total


def foresight_and_insitu(fields: dict, small: dict, hacc, base, eb: float, cpu_pair: list,
                         device) -> dict:
    """The Foresight and in-situ phases, each timed; returns the launches of
    K3, K4, K6 and K7 over all of them (the two-process groups' included).
    The host analyses (FoF catalogs, P(k) gates) run in a pool of processes
    beside the card's phases, the two-process groups in their own."""
    total = dict.fromkeys(FORESIGHT_KERNELS + SHARDED_KERNELS, 0)

    def phase(label, t0, launches=None):
        for k, v in (launches or {}).items():
            total[k] += v
        print(f"phase {label}: {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    launches, rows = cbench_sweep(fields, device)
    phase("CBench sweep (30 cases at 256^3)", t0, launches)
    t_all = time.perf_counter()
    procs = insitu_start(fields["baryon_density"], eb)
    card_pair = sharded_start("cuda")
    pool = ProcessPoolExecutor(HOST_WORKERS, mp_context=multiprocessing.get_context("spawn"))
    try:
        t0 = time.perf_counter()
        jobs, launches = halo_start(pool, device)
        phase("halo gate, card and CPU reconstructions (FoF queued)", t0, launches)
        t0 = time.perf_counter()
        launches = guideline_on_card(fields, rows, pool, device)
        del rows
        phase("guideline at 256^3", t0, launches)
        t0 = time.perf_counter()
        guideline_card_vs_cpu(small, device)
        phase(f"guideline card vs CPU at {SMALL_N}^3", t0)
        t0 = time.perf_counter()
        phase("PAT workflow example", t0, pat_workflow(device))
        t0 = time.perf_counter()
        decodes, streams, launches = insitu_one_rank(base, eb, device)
        phase("in-situ one-rank group", t0, launches)
        t0 = time.perf_counter()
        phase("in-situ two-process groups and checkpoint", t0,
              insitu_finish(procs, decodes, streams, device))
        t0 = time.perf_counter()
        phase("sharded snapshots, raw DTensor leaves and the gradient hop", t0,
              sharded_finish({"cuda": card_pair, "cpu": cpu_pair}, fields, hacc, small, device))
        t0 = time.perf_counter()
        halo_finish(jobs)
        phase("halo gate, FoF results", t0)
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(INSITU_DIR, ignore_errors=True)
    print(f"phase Foresight and in-situ after the sweep: {time.perf_counter() - t_all:.2f} s; "
          f"their launches: {json.dumps(total)}")
    return total


# --------------------------------------------- the router (phase 22) -----

ROUTER_REPLICAS = 2
# the reference tests' drill settings; fault-free runs use the real clock and
# no tick deadline (a first prefill may take longer than any fixed budget)
ROUTER_DRILL = dict(tick_deadline_s=0.5, max_retries=3, health_failures=2, probe_every=2,
                    probe_successes=2, integrity_every=1)


def routed(model, params, ps, plan=None, cfg=None):
    """Submit ``ps`` through a router over ROUTER_REPLICAS engines of SERVE
    sharing ``params``, with ``plan``'s faults under a ``DrillClock`` (real
    clock and no faults when ``plan`` is None), and drain it; the launch
    counts, page gathers and the metrics registry are reset just before.
    Returns (router, engines, injector, result, launches, page gathers, wall s)."""
    obs_metrics.reset()
    clock = DrillClock() if plan is not None else time.time
    injector = ServeFaultInjector(plan, clock=clock) if plan is not None else None
    engines = [ServingEngine(model, params, EngineConfig(**SERVE), clock=clock,
                             tick_hook=injector.hook_for(r) if injector else None)
               for r in range(ROUTER_REPLICAS)]
    router = Router(engines, cfg or RouterConfig(integrity_every=1), clock=clock)
    for i, p in enumerate(ps):
        router.submit(RouterRequest(uid=i, prompt=list(p), max_new_tokens=SERVE_NEW))
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    with GatherCount() as gathers:
        t0 = time.perf_counter()
        result = router.run_until_drained(max_ticks=5000)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    check(result.drained, "the router did not drain")
    check(len(result) == len(ps) and all(r.finished for r in result),
          f"{len(result)} of {len(ps)} routed requests came back, some unfinished")
    for r in result:
        check(r.status == "done" or (r.shed is not None and r.shed.reason in SHED_REASONS),
              f"request {r.uid} ended {r.status} without a typed reason")
    return router, engines, injector, result, kernels.launch_counts(), gathers.n, wall


def redispatch_chains() -> dict:
    """{uid: the tokens kept at each of its re-dispatches, in order} from
    the router's events (each re-dispatch re-prefills prompt + those)."""
    chains: dict = {}
    for e in obs_metrics.events("router.redispatch"):
        chains.setdefault(e["uid"], []).append(e["kept_tokens"])
    return chains


def hold_drill(model, params, ps, result, want: dict, label: str) -> dict:
    """Never-moved requests equal the fault-free tokens bitwise.  A moved
    request's prefix before its first re-dispatch equals them, and each
    later stretch equals what a fresh replica decodes from the prefix that
    dispatch was handed (one engine of SERVE runs every such continuation):
    re-dispatch is exact, though not the fault-free tokens, since a
    re-prefill is another bf16 program than K10's decode (phase 19's
    ``xla_agree_after_first``).  Returns {uid: (kept per re-dispatch, tokens
    agreeing with the fault-free run)}."""
    chains = redispatch_chains()
    conts = []
    for r in result:
        if r.status != "done":
            continue
        if r.uid not in chains:
            check(r.retries == 0 and len(r.attempts) == 1,
                  f"{label}: request {r.uid} moved without a re-dispatch event")
            check(r.tokens == want[r.uid], f"{label}: never-moved request {r.uid} differs "
                  "from the fault-free run")
            continue
        ks = chains[r.uid]
        check(ks == sorted(ks) and len(r.tokens) == SERVE_NEW,
              f"{label}: request {r.uid} kept {ks} tokens, ended with {len(r.tokens)}")
        check(r.tokens[:ks[0]] == want[r.uid][:ks[0]],
              f"{label}: request {r.uid}'s first kept prefix of {ks[0]} tokens differs")
        for j, k in enumerate(ks):
            end = ks[j + 1] if j + 1 < len(ks) else SERVE_NEW
            conts.append((r, k, end, Request(uid=r.uid, prompt=list(ps[r.uid]) + r.tokens[:k],
                                             max_new_tokens=SERVE_NEW - k, key_offset=k)))
    if conts:
        eng = ServingEngine(model, params, EngineConfig(**SERVE))
        for *_, q in conts:
            eng.submit(q)
        check(eng.run_until_drained().drained, f"{label}: the fresh replica did not drain")
    for r, k, end, q in conts:
        check(r.tokens[k:end] == q.out_tokens[:end - k],
              f"{label}: request {r.uid}'s tokens {k}:{end} differ from a fresh replica's "
              f"continuation of its {k}-token prefix")
    return {uid: (ks, sum(a == b for a, b in zip(r.tokens, want[uid])))
            for uid, ks in chains.items() for r in result if r.uid == uid}


def router_full_width(device, want: list) -> dict:
    """Phase 22: starcoder2-3b at its published widths (phase 19's bf16
    weights, drawn again from SEED on the card) behind the router, two
    replicas each with its own paged blockfloat8 pool; ``want`` holds
    phase 19's single-engine tokens."""
    cfg = registry.get_config(ARCH)
    model = registry.build_model(cfg)
    params = init_params(model.specs(), torch.Generator(device=device).manual_seed(SEED),
                         device, torch.bfloat16)
    ps = prompts(SERVE_REQUESTS, cfg.vocab, *PROMPT_LEN)
    ref = dict(enumerate(want))
    out, launches = {}, 0
    obs_metrics.enable()
    try:
        # (a) fault-free
        torch.cuda.reset_peak_memory_stats()
        router, engines, _, result, counts, gathers, wall = routed(model, params, ps)
        peak = torch.cuda.max_memory_allocated() / 2**30
        steps = sum(e.steps for e in engines)
        k10_n = counts["kvc_decode_attention"]
        check(k10_n == cfg.n_layers * steps and k10_n > 0,
              f"routed: K10 launched {k10_n} times in {steps} decode steps of {cfg.n_layers} layers")
        pre = obs_metrics.histogram("serving.prefill_s").percentiles()
        tick = obs_metrics.histogram("serving.tick_s").percentiles()
        check(gathers == 4 * cfg.n_layers * pre["count"],
              f"routed: {gathers} page gathers in {pre['count']} prefill calls: decode gathered")
        check(all(e.check_kv_integrity() for e in engines), "routed: a pool is not clean")
        check(obs_metrics.counter("router.quarantined").value == 0 and len(router.healthy())
              == ROUTER_REPLICAS, "routed: a replica was quarantined in a fault-free run")
        check(not result.shed_requests, "routed: a fault-free run shed requests")
        diff = [r.uid for r in result if r.tokens != ref[r.uid]]
        check(not diff, f"routed tokens differ from phase 19's single engine for {diff}")
        launches += k10_n
        decode_s = tick["mean"] * tick["count"] - pre["mean"] * pre["count"]
        out["fault_free"] = {
            "replicas": ROUTER_REPLICAS, "router_ticks": router.ticks, "decode_steps": steps,
            "k10_launches": k10_n, "page_gathers": gathers, "prefill_calls": pre["count"],
            "wall_s": wall, "decode_tokens_per_s": SERVE_REQUESTS * (SERVE_NEW - 1) / decode_s,
            "peak_gib": peak, "per_replica_requests": [
                sum(1 for r in result if r.attempts == [e]) for e in range(ROUTER_REPLICAS)]}

        # (b) the canonical drill
        plan = ServeFaultPlan.drill(seed=0, n_replicas=ROUTER_REPLICAS)
        router, engines, injector, result, counts, _, wall = routed(
            model, params, ps, plan, RouterConfig(**ROUTER_DRILL))
        moved = hold_drill(model, params, ps, result, ref, "drill")
        launches += counts["kvc_decode_attention"]
        out["drill"] = {
            "plan": json.loads(plan.to_json()), "fired": injector.log,
            "quarantines": obs_metrics.counter("router.quarantined").value,
            "redispatches": obs_metrics.counter("router.redispatched").value,
            "readmits": obs_metrics.counter("router.readmitted").value,
            "completed": len(result.completed), "shed": [(r.uid, r.shed.reason)
                                                         for r in result.shed_requests],
            "moved_kept_agree": moved, "router_ticks": router.ticks, "wall_s": wall,
            "k10_launches": counts["kvc_decode_attention"]}
        check(len(injector.log) == len(plan.events), f"drill fired {injector.log}")

        # (c) one poison of the zero page: caught, and nothing decoded against it escapes
        plan = ServeFaultPlan.single("kv_poison", replica=0, tick=2, seed=0)
        seen: dict = {}

        def watch(engine, _hook=None):
            if engine.ticks == 2:  # the poisoned tick, before it decodes
                seen.update({s.uid: len(s.out_tokens) for s in engine.slots if s is not None})

        obs_metrics.reset()
        clock = DrillClock()
        injector = ServeFaultInjector(plan, clock=clock)
        hooks = [injector.hook_for(r) for r in range(ROUTER_REPLICAS)]

        def hook0(engine):
            watch(engine)
            hooks[0](engine)

        engines = [ServingEngine(model, params, EngineConfig(**SERVE), clock=clock,
                                 tick_hook=hook0 if r == 0 else hooks[r])
                   for r in range(ROUTER_REPLICAS)]
        router = Router(engines, RouterConfig(**ROUTER_DRILL), clock=clock)
        for i, p in enumerate(ps):
            router.submit(RouterRequest(uid=i, prompt=list(p), max_new_tokens=SERVE_NEW))
        kernels.reset_launch_counts()
        result = router.run_until_drained(max_ticks=5000)
        torch.cuda.synchronize()
        launches += kernels.launch_counts()["kvc_decode_attention"]
        check(result.drained and all(r.finished for r in result), "poison: not drained")
        quarantines = obs_metrics.events("router.quarantine")
        check(injector.log == [(0, 2, "kv_poison")] and any(
            q["replica"] == 0 and q["cause"].startswith("kv_integrity") for q in quarantines),
            f"poison: fired {injector.log}, quarantines {quarantines}")
        chains = redispatch_chains()
        check(seen and set(seen) <= set(chains), f"poison: live at the poisoned tick {seen}, "
              f"moved {chains}")
        for uid, n in seen.items():
            check(chains[uid][0] <= n, f"poison: request {uid} kept {chains[uid][0]} tokens, "
                  f"{n} were decoded before the poison")
        moved = hold_drill(model, params, ps, result, ref, "poison")
        out["poison"] = {"live_at_poison": seen, "moved_kept_agree": moved,
                         "quarantines": len(quarantines), "router_ticks": router.ticks}
    finally:
        obs_metrics.disable()
        obs_metrics.reset()
    del params
    torch.cuda.empty_cache()
    print(f"router {ARCH} full width, {ROUTER_REPLICAS} replicas of {SERVE} ({card_line()}): "
          + json.dumps(out))
    return {"kvc_decode_attention": launches}


# ---------------------------------------------- training (phases 23-24) -----

TRAIN_ARCH = "minicpm-2b"  # the JAX launcher's example (repro/launch/train.py:4)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 256, 3  # the launcher's defaults; 3 steps
TRAIN_DIR = SNAPSHOT_DIR.parent / ".chip_smoke_train"  # gitignored; removed at the end
TRAIN_CUT_LAYERS = 1  # phase 24's depth cut at minicpm-2b's widths (PERF.md §4)


def fingerprint(t: torch.Tensor) -> int:
    return int(t.contiguous().view(torch.int32).sum(dtype=torch.int64))


def hop_bytes(sizes, cfg) -> int:
    """The compressed hop's gather per step and rank: each leaf's codes
    padded to whole blocks, plus one float32 scale per block."""
    blocks = [-(-n // cfg.block) for n in sizes]
    return sum(b * cfg.block * cfg.bits // 8 + 4 * b for b in blocks)


def train_full_width(device) -> dict:
    """Phase 23: minicpm-2b at its published widths, three compressed-hop
    steps on a one-rank NCCL ("pod", "data") mesh."""
    cfg = registry.get_config(TRAIN_ARCH)
    model = registry.build_model(cfg)
    gc = GradCompressionConfig(enabled=True)
    scfg = step_lib.TrainStepConfig(peak_lr=3e-4, warmup_steps=max(100 // 20, 1),
                                    total_steps=100, schedule="wsd", grad_comp=gc)
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated() / 2**30  # by the phases before
    mesh = make_mesh((1, 1), ("pod", "data"), "cuda")
    try:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state = step_lib.init_state(model, mesh, torch.Generator(device=device).manual_seed(SEED),
                                    scfg)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        leaves = tree_util.tree_flatten(state["params"])[0]
        before = [fingerprint(x) for x in leaves]
        n_params = sum(x.numel() for x in leaves)
        step = step_lib.build_train_step(model, mesh, scfg)
        pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                        global_batch=TRAIN_BATCH))
        want_wire = hop_bytes([x.numel() for x in leaves], gc)
        losses, ms, peaks = [], [], []
        state_gib = torch.cuda.memory_allocated() / 2**30
        kernels.reset_launch_counts()
        for i in range(TRAIN_STEPS):
            insitu.reset_sent_bytes()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, pipe.batch_at(i))
            losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            peaks.append(torch.cuda.max_memory_allocated() / 2**30)
            check(insitu.sent_bytes["all_gather"] == want_wire,
                  f"train step {i}: the hop gathered {insitu.sent_bytes['all_gather']} B, "
                  f"want {want_wire}")
        launches = {k: v for k, v in kernels.launch_counts().items() if v}
        peak = torch.cuda.max_memory_allocated() / 2**30
        check(all(math.isfinite(v) for v in losses), f"train losses {losses}")
        after = [fingerprint(x) for x in tree_util.tree_flatten(state["params"])[0]]
        unchanged = [i for i, (a, b) in enumerate(zip(before, after)) if a == b]
        check(not unchanged, f"train: parameter leaves {unchanged} did not change")
        del state, step
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    out = {"arch": TRAIN_ARCH, "params": n_params, "layers": cfg.n_layers,
           "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "losses": losses, "step_ms": ms,
           "tokens_per_s": [TRAIN_BATCH * TRAIN_SEQ / (t / 1e3) for t in ms],
           "init_s": init_s, "peak_gib": peak, "peak_gib_per_step": peaks,
           "state_gib": state_gib, "held_before_gib": held, "hop_bytes_per_step": want_wire,
           "launches": launches}
    print(f"training {TRAIN_ARCH} full width, f32 state, bf16 compute, AdamW + wsd, "
          f"compressed pod hop (bits 8, block 1024, error feedback), one-rank NCCL mesh "
          f"({card_line()}): " + json.dumps(out))
    return launches


class LoopCapture:
    """Records what ``train.loop.run`` returns while active: the launcher's
    (state, LoopResult) per call."""

    def __enter__(self):
        self.runs, self._orig = [], loop_lib.run

        def run(*args, **kwargs):
            out = self._orig(*args, **kwargs)
            self.runs.append(out)
            return out

        loop_lib.run = run
        return self

    def __exit__(self, *exc):
        loop_lib.run = self._orig


def launch_train(argv: list) -> tuple:
    with LoopCapture() as cap:
        check(launch_train_lib.main(argv) == 0, f"launch.train main {argv} failed")
    check(len(cap.runs) == 1, "the launcher ran the loop more than once")
    return cap.runs[0]


def train_start(dev: str) -> list:
    """A two-process gloo group (``pod`` = 2) on ``dev``, each rank this
    script with ``--train-rank``: three compressed-hop steps at SMOKE."""
    port = free_port()
    procs = []
    for rank in range(2):
        log = open(TRAIN_DIR / f"pair_r{rank}.log", "w")
        procs.append(subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--train-rank", str(rank), "2",
             str(port), dev, str(TRAIN_DIR)], stdout=log, stderr=subprocess.STDOUT))
    CHILD_PROCS.extend(procs)
    return procs


def train_worker(argv: list[str]) -> int:
    """One rank of :func:`train_start`'s pair; writes its parameters,
    losses and bytes sent to ``out/pair_rank{rank}.pkl``."""
    rank, world, port, dev, out = int(argv[0]), int(argv[1]), argv[2], argv[3], Path(argv[4])
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world,
                            rank=rank)
    try:
        cfg = registry.get_config(TRAIN_ARCH, smoke=True)
        model = registry.build_model(cfg, device=dev)
        mesh = make_mesh((world, 1), ("pod", "data"), torch.device(dev).type)
        gc = GradCompressionConfig(enabled=True)
        scfg = step_lib.TrainStepConfig(peak_lr=1e-3, warmup_steps=1, total_steps=10,
                                        schedule="wsd", grad_comp=gc)
        state = step_lib.init_state(model, mesh,
                                    torch.Generator(device=dev).manual_seed(SEED), scfg)
        step = step_lib.build_train_step(model, mesh, scfg)
        pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                        global_batch=TRAIN_BATCH))
        losses = []
        insitu.reset_sent_bytes()
        for i in range(TRAIN_STEPS):
            state, m = step(state, pipe.batch_at(i))
            losses.append(float(m["loss"]))
        res = {"losses": losses, "sent": dict(insitu.sent_bytes),
               "wire": TRAIN_STEPS * hop_bytes([x.numel() for x in tree_util.tree_flatten(
                   state["params"])[0]], gc),
               "params": [digest(x) for x in tree_util.tree_flatten(state["params"])[0]],
               "ef": [digest(x) for x in tree_util.tree_flatten(state["ef"])[0]]}
        with open(out / f"pair_rank{rank}.pkl", "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()
    return 0


def train_loop_phase(device) -> dict:
    """Phase 24: ``launch/train.py main`` on the card (the in-situ hook and a
    lossy checkpoint at a depth cut of minicpm-2b; a bitwise restart at
    SMOKE), and a two-process gloo pair of compressed-hop steps."""
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    TRAIN_DIR.mkdir(parents=True)
    pair = train_start("cuda")
    out = {}
    try:
        # the hook and the lossy checkpoint at minicpm-2b's widths, depth cut
        # (no --lossy-ckpt here: the 1-D SZ path refuses a leaf of 2^26 points or
        # more, in the reference as in the port, and the embedding has 2^28)
        cut = TRAIN_DIR / "cut"
        flags = ["--arch", TRAIN_ARCH, "--steps", "4", "--ckpt-every", "2", "--insitu-snapshot"]
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        end, res = launch_train(flags + ["--layers", str(TRAIN_CUT_LAYERS),
                                         "--ckpt-dir", str(cut)])
        torch.cuda.synchronize()
        cut_s = time.perf_counter() - t0
        cut_launches = {k: v for k, v in kernels.launch_counts().items() if v}
        check(res.final_step == 4 and len(res.losses) == 4 and len(res.snapshot_s) == 2
              and all(math.isfinite(v) for v in res.losses), f"depth-cut run: {res}")
        live = dict(launch_train_lib._leaf_entries(end, 1 << 20))
        kb, rest = insitu.plan_kernel_buckets(
            [(k, tuple(v.shape), v.dtype, ()) for k, v in live.items()], ONE_DEVICE)
        fb, skipped = insitu.plan_arena(rest, ONE_DEVICE)
        # the per-leaf route's 1-D coder refuses n * 32 >= 2^31, as the
        # reference's does: the hook says so and skips the leaf
        per_leaf = [k for k, _ in skipped if live[k].numel() * 32 < 2**31]
        too_big = sorted(k for k, _ in skipped if k not in per_leaf)
        names = ([f"karena{k:03d}" for k in range(len(kb))]
                 + [f"arena{k:03d}" for k in range(len(fb))] + per_leaf)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        back, extra = ckpt.CheckpointManager(cut / "fields").restore(
            4, state_like=dict.fromkeys(names, 0))
        torch.cuda.synchronize()
        fields_ms = (time.perf_counter() - t0) * 1e3
        fields_launches = {k: v for k, v in kernels.launch_counts().items() if v}
        eb = 1e-3  # the launcher's --insitu-eb default
        worst, n = 0.0, 0
        for key, v in back.items():
            for name, t in (v.items() if isinstance(v, dict) else [(key, v)]):
                err = float((t.to(device, torch.float32)
                             - live[name].to(torch.float32)).abs().max())
                check(err <= eb * (1 + 1e-5), f"fields restore {name}: max err {err} > {eb}")
                worst, n = max(worst, err), n + 1
        check(n == extra["n_fields"] == len(live) - len(too_big),
              f"fields: {n} restored, {len(live)} live, {too_big} too large")
        t0 = time.perf_counter()
        ck, _ = ckpt.CheckpointManager(cut).restore(4, state_like=end)
        ckpt_ms = (time.perf_counter() - t0) * 1e3
        check(all(same(a.to(device), b) for a, b in zip(tree_util.tree_flatten(ck)[0],
                                                        tree_util.tree_flatten(end)[0])),
              "the step-4 checkpoint does not restore the state bitwise")
        out["depth_cut"] = {"layers": TRAIN_CUT_LAYERS, "losses": res.losses,
                            "step_s": res.step_s, "snapshot_dispatch_s": res.snapshot_s,
                            "wall_s": cut_s, "fields": n, "kernel_buckets": len(kb),
                            "flat_buckets": len(fb), "per_leaf": len(per_leaf),
                            "skipped_too_large": too_big,
                            "fields_restore_ms": fields_ms, "fields_max_err": worst,
                            "ckpt_restore_ms": ckpt_ms,
                            "launches": cut_launches, "restore_launches": fields_launches}
        del end, ck, back, live
        torch.cuda.empty_cache()

        # restart from the step-2 checkpoint at SMOKE: bitwise steps 3-4
        smoke = flags + ["--lossy-ckpt", "--smoke"]
        a_dir, b_dir = TRAIN_DIR / "a", TRAIN_DIR / "b"
        end_a, res_a = launch_train(smoke + ["--ckpt-dir", str(a_dir)])
        b_dir.mkdir()
        shutil.copytree(a_dir / "step_000000002", b_dir / "step_000000002")
        end_b, res_b = launch_train(smoke + ["--ckpt-dir", str(b_dir)])
        check(len(res_b.losses) == 2 and res_b.losses == res_a.losses[2:],
              f"restart losses {res_b.losses} != {res_a.losses[2:]}")
        check(all(same(x, y) for x, y in zip(tree_util.tree_flatten(end_b)[0],
                                             tree_util.tree_flatten(end_a)[0])),
              "restart: the state after step 4 differs from the uninterrupted run's")
        out["restart"] = {"losses": res_a.losses, "resumed": res_b.losses}
        if dist.is_initialized():  # the launcher's one-rank host mesh
            dist.destroy_process_group()

        wait_train(pair)
        r0, r1 = (pickle.load(open(TRAIN_DIR / f"pair_rank{r}.pkl", "rb")) for r in range(2))
        check(r0["params"] == r1["params"] and r0["losses"] == r1["losses"],
              "pair: the two pod ranks' parameters or losses differ")
        check(r0["ef"] != r1["ef"], "pair: both pods kept the same error feedback")
        check(r0["sent"]["all_gather"] == r1["sent"]["all_gather"] == r0["wire"],
              f"pair: gathered {r0['sent']}, want {r0['wire']}")
        out["pair"] = {"losses": r0["losses"], "all_gather_bytes": r0["wire"]}
    finally:
        for p in pair:
            if p.poll() is None:
                p.kill()
                p.wait()
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    print(f"training loop ({card_line()}): " + json.dumps(out))
    launches = dict(out["depth_cut"]["launches"])
    for k, v in out["depth_cut"]["restore_launches"].items():
        launches[k] = launches.get(k, 0) + v
    return launches


def wait_train(procs: list) -> None:
    for p in procs:
        try:
            rc = p.wait(timeout=600)
        except subprocess.TimeoutExpired:
            p.kill()
            rc = "timeout"
        if rc != 0:
            logs = "\n".join(q.read_text()[-3000:] for q in sorted(TRAIN_DIR.glob("pair_r*.log")))
            raise RuntimeError(f"chip_smoke check failed: train pair rank exited {rc}\n{logs}")


# ------------------------------------ the supervised drill (phases 25-26) -----

DRILL_DIR = SNAPSHOT_DIR.parent / ".chip_smoke_drill"  # gitignored; removed at the end
# phase 25: FaultPlan.drill(0, 8, 2) loses its pod at step 6, after the second snapshot
DRILL_STEPS, DRILL_EVERY, DRILL_GROW = 8, 2, 2
DRILL_RANKS = 8  # phase 26: the reference's 8-device drill at its mesh
DRILL_SHAPE = {"pod": 2, "data": 2, "model": 2}
DRILL_SPANS = ("train.step", "snapshot.dispatch", "supervisor.quiesce", "supervisor.restore",
               "supervisor.grow_back")


def span_ms() -> dict:
    """Milliseconds of this process's recorded spans, by name."""
    out: dict = {}
    for ev in obs_trace.TRACER.events:
        if ev.get("ph") == "X" and ev["name"] in DRILL_SPANS:
            out.setdefault(ev["name"], []).append(ev["dur"] / 1e3)
    return out


class SuperviseCapture:
    """Records what ``train.supervisor.run_supervised`` returns while active,
    with the injector it was given."""

    def __enter__(self):
        self.runs, self._orig = [], sup.run_supervised

        def run(*args, **kwargs):
            state, res = self._orig(*args, **kwargs)
            self.runs.append((state, res, kwargs.get("injector")))
            return state, res

        sup.run_supervised = run
        return self

    def __exit__(self, *exc):
        sup.run_supervised = self._orig


def supervised_phase(device) -> dict:
    """Phase 25: ``launch/train.py main --supervise`` with the seeded drill at
    minicpm-2b's widths cut to one layer, one rank on the card."""
    ckdir = DRILL_DIR / "one"
    plan = faults_lib.FaultPlan.drill(0, DRILL_STEPS, DRILL_EVERY)
    (fault,) = [e for e in plan.events if e.kind == "pod_loss"]
    # the corrupted snapshot is the newest at the fault; the restore falls
    # back one interval past it
    want_restored = fault.step // DRILL_EVERY * DRILL_EVERY - DRILL_EVERY
    flags = ["--arch", TRAIN_ARCH, "--layers", str(TRAIN_CUT_LAYERS), "--supervise",
             "--fault-seed", "0", "--steps", str(DRILL_STEPS), "--ckpt-every", str(DRILL_EVERY),
             "--grow-back-after", str(DRILL_GROW), "--insitu-snapshot", "--ckpt-dir", str(ckdir),
             "--metrics-dir", str(DRILL_DIR / "obs"), "--trace"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        with SuperviseCapture() as cap:
            check(launch_train_lib.main(flags) == 0, f"launch.train main {flags} failed")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: v for k, v in kernels.launch_counts().items() if v}
        peak = torch.cuda.max_memory_allocated() / 2**30
        spans = span_ms()
    finally:
        obs_metrics.disable()
        obs_trace.disable()
        obs_trace.clear()
        if dist.is_initialized():  # the launcher's one-rank host mesh
            dist.destroy_process_group()
    check(len(cap.runs) == 1, "the launcher ran the supervisor more than once")
    _, res, inj = cap.runs.pop()
    check(inj.log == [(e.step, e.kind) for e in plan.events],
          f"injector log {inj.log} != the plan {plan.to_json()}")
    shrinks = [t for t in res.transitions if t.kind == "shrink"]
    grows = [t for t in res.transitions if t.kind == "grow"]
    check(len(shrinks) == 1 and shrinks[0].at_step == fault.step
          and shrinks[0].restored_step == want_restored and shrinks[0].quarantined == 1,
          f"shrink transitions {shrinks}, want one at {fault.step} restoring {want_restored}")
    check(len(grows) == 1 and grows[0].at_step == want_restored + DRILL_GROW,
          f"grow transitions {grows}")
    quarantined = sorted(p.name for p in ckdir.glob("quarantine/step_*"))
    check(quarantined == [f"step_{fault.step // DRILL_EVERY * DRILL_EVERY:09d}"],
          f"quarantine holds {quarantined}")
    check(any(k == "shrink-restore" for *_, k in res.continuity),
          f"no shrink-restore continuity check in {res.continuity}")
    check(res.final_step == DRILL_STEPS and all(math.isfinite(v) for _, v in res.loss_trace),
          f"final step {res.final_step}, losses {res.loss_trace}")
    check(not launches, f"the supervised drill launched {launches}")
    out = {"arch": TRAIN_ARCH, "layers": TRAIN_CUT_LAYERS, "plan": json.loads(plan.to_json()),
           "wall_s": wall, "final_step": res.final_step,
           "steps": [s for s, _ in res.loss_trace], "losses": [v for _, v in res.loss_trace],
           "transitions": [dataclasses.asdict(t) for t in res.transitions],
           "quarantined": quarantined, "step_ms": spans.get("train.step"),
           "snapshot_dispatch_ms": spans.get("snapshot.dispatch"),
           "quiesce_ms": spans.get("supervisor.quiesce"),
           "restore_ms": spans.get("supervisor.restore"),
           "grow_back_ms": spans.get("supervisor.grow_back"),
           "fetch_stall_s": [e.stall_s for e in plan.events if e.kind == "fetch_stall"],
           "peak_gib": peak, "launches": launches}
    print(f"supervised drill, one rank ({card_line()}): " + json.dumps(out))
    return launches


def drill_start(dev: str) -> list:
    """Phase 26's group: ``DRILL_RANKS`` gloo ranks on ``dev`` (on the card all
    on cuda:0), each this script with ``--drill-rank``."""
    (DRILL_DIR / dev).mkdir(parents=True, exist_ok=True)
    port = free_port()
    procs = []
    for rank in range(DRILL_RANKS):
        log = open(DRILL_DIR / dev / f"r{rank}.log", "w")
        procs.append(subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--drill-rank", str(rank),
             str(DRILL_RANKS), str(port), dev, str(DRILL_DIR / dev)],
            stdout=log, stderr=subprocess.STDOUT))
    CHILD_PROCS.extend(procs)
    return procs


def drill_worker(argv: list[str]) -> int:
    """One rank of :func:`drill_start`'s group: the reference's
    ``test_fault_drill_8dev`` plan at minicpm-2b SMOKE under
    ``run_supervised``; writes its result to ``out/rank{rank}.pkl``."""
    import functools
    import hashlib

    rank, world, port, dev, out = int(argv[0]), int(argv[1]), argv[2], argv[3], Path(argv[4])
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world,
                            rank=rank)
    try:
        cfg = registry.get_config(TRAIN_ARCH, smoke=True)
        model = registry.build_model(cfg, device=dev)
        scfg = step_lib.TrainStepConfig(peak_lr=1e-3, warmup_steps=1)
        plan = faults_lib.FaultPlan.from_events([
            faults_lib.FaultEvent(step=5, kind="drain_io", count=1),
            faults_lib.FaultEvent(step=9, kind="corrupt_payload", mode="truncate", seed=3),
            faults_lib.FaultEvent(step=9, kind="pod_loss", lost_pods=1),
        ])
        ckdir = out / "ckpt"
        inj = faults_lib.FaultInjector(plan, ckpt_dir=ckdir)
        ckpt_mgr = ckpt.CheckpointManager(ckdir, async_save=True, write_bytes=inj.write_bytes,
                                          fetch_hook=inj.fetch_hook, retry_backoff_s=0.01,
                                          device=dev, group=dist.new_group(backend="gloo"))
        inj.manager = ckpt_mgr
        builder = functools.partial(sup.make_trainer, model, vocab=cfg.vocab, seq_len=16,
                                    step_cfg=scfg)
        obs_trace.enable()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        state, res = sup.run_supervised(
            builder, DRILL_SHAPE, 8, ckpt_mgr,
            sup.SupervisorConfig(total_steps=18, ckpt_every=4, drain_deadline_s=30.0,
                                 grow_back_after=4),
            injector=inj, log=print if rank == 0 else (lambda s: None))
        ckpt_mgr.wait()
        wall = time.perf_counter() - t0
        leaves = tree_util.tree_flatten(state)[0]
        digests = [hashlib.sha256(sharding.local(x).detach().reshape(-1).view(torch.uint8).cpu()
                                  .numpy().tobytes()).hexdigest() for x in leaves]
        result = {"final_step": res.final_step, "log": inj.log, "wall_s": wall,
                  "split": sum(sharding.is_dtensor(x) for x in leaves),
                  "meshes": sorted({tuple(x.device_mesh.shape) for x in leaves
                                    if sharding.is_dtensor(x)}),
                  "transitions": [dataclasses.asdict(t) for t in res.transitions],
                  "loss_trace": res.loss_trace, "continuity": res.continuity,
                  "digests": digests, "spans_ms": span_ms(),
                  "launches": {k: v for k, v in kernels.launch_counts().items() if v},
                  "quarantined": sorted(p.name for p in ckdir.glob("quarantine/step_*"))}
        with open(out / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(result, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


def drill_results(procs: list, dev: str) -> list:
    """Wait for a group of :func:`drill_start` (a timeout per rank) and
    return each rank's result; a rank that exits non-zero fails the run."""
    for p in procs:
        try:
            rc = p.wait(timeout=600)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
            rc = "timeout"
        if rc != 0:
            logs = "\n".join(q.read_text()[-3000:] for q in sorted((DRILL_DIR / dev).glob("r*.log")))
            raise RuntimeError(f"chip_smoke check failed: {dev} drill rank exited {rc}\n{logs}")
    return [pickle.load(open(DRILL_DIR / dev / f"rank{r}.pkl", "rb")) for r in range(DRILL_RANKS)]


def hold_drill_group(runs: list, dev: str) -> None:
    """The reference's expected values of ``test_fault_drill_8dev`` on every
    rank, the same losses on all of them, and bitwise-equal blocks on the two
    ranks (one per pod) at each (data, model) coordinate."""
    for r, run in enumerate(runs):
        check(run["final_step"] == 18, f"{dev} rank {r}: final step {run['final_step']}")
        check(run["log"] == [(5, "drain_io"), (9, "corrupt_payload"), (9, "pod_loss")],
              f"{dev} rank {r}: injector log {run['log']}")
        shrink, grow = run["transitions"]
        check(shrink["kind"] == "shrink" and shrink["at_step"] == 9
              and shrink["restored_step"] == 4 and shrink["quarantined"] == 1
              and shrink["mesh_shape"] == {"pod": 1, "data": 2, "model": 2}
              and shrink["global_batch"] == 8,
              f"{dev} rank {r}: shrink {shrink}")
        check(grow["kind"] == "grow" and grow["at_step"] == 8 and grow["mesh_shape"] == DRILL_SHAPE,
              f"{dev} rank {r}: grow {grow}")
        check(any(k == "shrink-restore" for *_, k in run["continuity"]),
              f"{dev} rank {r}: no shrink-restore continuity check")
        check(all(math.isfinite(v) for _, v in run["loss_trace"])
              and [s for s, _ in run["loss_trace"]] == list(range(9)) + list(range(4, 18)),
              f"{dev} rank {r}: step trace {run['loss_trace']}")
        check(run["split"] > 0 and run["meshes"] == [(2, 2, 2)],
              f"{dev} rank {r}: {run['split']} split leaves on meshes {run['meshes']}")
        check(run["loss_trace"] == runs[0]["loss_trace"], f"{dev} rank {r}: other losses")
        check(run["digests"] == runs[r % 4]["digests"],
              f"{dev} rank {r}: blocks differ from pod 0's at its (data, model) coordinate")
        check(not run["launches"], f"{dev} rank {r} launched {run['launches']}")
    check(runs[0]["quarantined"] == ["step_000000008"],
          f"{dev}: quarantine holds {runs[0]['quarantined']}")


def drill_phase(cpu_group: list) -> dict:
    """Phase 26: the shrink and grow-back drill on 8 gloo ranks on the card,
    held to the reference's values and to the same drill's CPU group."""
    card = drill_results(drill_start("cuda"), "cuda")
    hold_drill_group(card, "cuda")
    cpu = drill_results(cpu_group, "cpu")
    hold_drill_group(cpu, "cpu")
    check(card[0]["transitions"] == cpu[0]["transitions"]
          and [s for s, _ in card[0]["loss_trace"]] == [s for s, _ in cpu[0]["loss_trace"]],
          "the card group's transitions or step trace differ from the CPU group's")
    out = {"ranks": DRILL_RANKS, "mesh": DRILL_SHAPE, "transitions": card[0]["transitions"],
           "losses": [v for _, v in card[0]["loss_trace"]],
           "cpu_losses": [v for _, v in cpu[0]["loss_trace"]],
           "wall_s": [r["wall_s"] for r in card], "cpu_wall_s": [r["wall_s"] for r in cpu],
           "rank0_spans_ms": {k: v for k, v in card[0]["spans_ms"].items() if k != "train.step"},
           "rank0_step_ms": card[0]["spans_ms"].get("train.step"),
           "rank4_spans_ms": {k: v for k, v in card[4]["spans_ms"].items() if k != "train.step"}}
    print(f"supervised drill, {DRILL_RANKS} gloo ranks ({card_line()}): " + json.dumps(out))
    return {}


# ------------------------- the other model families (phases 27-28) -----------

MOE_ARCH = "qwen3-moe-30b-a3b"  # the one MoE config that fits one card at its published size
# phase 27's depth: 16 of 48 layers keep the script inside its time limit
# (all 48, 30.5 B parameters, took 77-83 s of it)
MOE_LAYERS = 16
SERIAL_ARCHS = ("rwkv6-1.6b", "hymba-1.5b")  # token-by-token engine fallback, no K10 route
SERIAL = dict(batch_slots=4, max_len=128, codec="blockfloat8")
SERIAL_REQUESTS, SERIAL_NEW, SERIAL_PROMPT = 6, 12, (8, 24)
WHISPER = "whisper-base"
WHISPER_LANES, WHISPER_STEPS = 8, 16
FAMILY_SMOKE = ("qwen3-moe-30b-a3b", "phi3.5-moe-42b-a6.6b", "rwkv6-1.6b", "hymba-1.5b",
                WHISPER)
SMOKE_ULPS = 4  # card vs CPU at SMOKE: bf16 ulps of the largest |logit|
FAMILY_STEPS = 8  # SMOKE decode steps held card vs CPU
HYMBA = "hymba-1.5b"
HYMBA_INDEX = (1250, 1100, 300)  # two lanes past the 1024-token window, one inside it
HYMBA_REL = 1e-4  # float32 card vs CPU, of the largest |logit|


def moe_kvc_shape() -> tuple:
    """K10's (B, S, H, Hkv, D) on phase 27's decode: qwen3-moe in phase 19's engine."""
    c = registry.get_config(MOE_ARCH)
    return (SERVE["batch_slots"], SERVE["max_len"], c.n_heads, c.n_kv_heads, c.hd)


def whisper_kvc_shape() -> tuple:
    """K10's (B, S, H, Hkv, D) on phase 28's whisper decode (dense entry)."""
    c = registry.get_config(WHISPER)
    return (WHISPER_LANES, WHISPER_STEPS + 1, c.n_heads, c.n_kv_heads, c.hd)


def bf16_ulp(x: float) -> float:
    return 2.0 ** (math.floor(math.log2(x)) - 7) if x > 0 else 0.0


def k10_exact(q, kc, ks, vc, vs, index):
    """K10's function in float64 on a dense cache, with the terms of
    :class:`K10Held`'s bar: (out, L, V, S) where L is the largest
    D^-0.5 * sum |q_d k_d| (a bound on |logit|) and V the largest |v| over
    the positions a lane attends to, S the longest such stretch."""
    n_rep = q.shape[1] // kc.shape[2]
    k = torch.repeat_interleave(kc.double() * ks.double()[..., None], n_rep, dim=2)
    v = torch.repeat_interleave(vc.double() * vs.double()[..., None], n_rep, dim=2)
    scale = q.shape[-1] ** -0.5
    idx = torch.as_tensor(index, dtype=torch.int32, device=q.device).reshape(-1)
    idx = idx.expand(q.shape[0]) if idx.numel() == 1 else idx
    mask = torch.arange(k.shape[1], device=q.device)[None, :] <= idx[:, None]  # (B, S)
    logits = torch.einsum("bhd,bshd->bhs", q.double(), k) * scale
    p = torch.softmax(logits.masked_fill(~mask[:, None, :], -math.inf), dim=-1)
    out = torch.einsum("bhs,bshd->bhd", torch.nan_to_num(p) * mask[:, None, :], v)
    bound = torch.einsum("bhd,bshd->bhs", q.double().abs(), k.abs()) * scale
    lmax = float(bound.masked_fill(~mask[:, None, :], 0).max())
    vmax = float(v.abs().masked_fill(~mask[:, :, None, None], 0).max())
    return out, lmax, vmax, int((idx + 1).clamp_min(0).max())


class K10Held:
    """While active, holds every call of K10's two entries (``kernels.ops``,
    which the models call) against the same function in float64 on the same
    inputs (:func:`k10_exact`): within half an ulp of the output's dtype
    (its rounding) plus 2^-24 * V * (L + S), about what float32 rounding of
    the logits (L) and of the sum over S positions moves a softmax-weighted
    mean of values up to V by.  The plain float32 version's own distance
    from float64 is recorded beside it.  The kernel's output is returned;
    the comparison launches no K10."""

    def __enter__(self):
        self._orig = (ops.kvc_attention, ops.kvc_attention_paged)
        self.calls, self.err, self.plain_err, self.share = 0, 0.0, 0.0, 0.0

        def held(fn, paged):
            def call(*args):
                got = fn(*args)
                dense = ((args[0], *(kref.gather_pages(t, args[5]) for t in args[1:5]), args[6])
                         if paged else args)
                ex, lmax, vmax, slen = k10_exact(*dense)
                half = torch.finfo(got.dtype).eps * torch.ldexp(torch.ones_like(ex),
                                                                torch.frexp(ex.abs())[1] - 2)
                bar = 2.0 ** -24 * vmax * (lmax + slen)
                excess = float(((got.double() - ex).abs() - half).max())
                check(excess <= bar, f"K10 call {self.calls} ({'paged' if paged else 'dense'}, "
                      f"cache {tuple(dense[1].shape)}) is {excess} beyond its output rounding "
                      f"from float64 (bar {bar}: L {lmax}, V {vmax}, S {slen})")
                plain = kref.kvc_decode_attention_ref(dense[0].float(), *dense[1:])
                self.plain_err = max(self.plain_err, float((plain.double() - ex).abs().max()))
                self.err = max(self.err, float((got.double() - ex).abs().max()))
                self.share = max(self.share, max(excess, 0.0) / bar)
                self.calls += 1
                return got
            return call

        ops.kvc_attention = held(self._orig[0], False)
        ops.kvc_attention_paged = held(self._orig[1], True)
        return self

    def __exit__(self, *exc):
        ops.kvc_attention, ops.kvc_attention_paged = self._orig

    def summary(self) -> dict:
        return {"calls": self.calls, "max_abs_from_f64": self.err,
                "plain_f32_max_abs_from_f64": self.plain_err,
                "largest_share_of_bar": self.share}


class DropCount:
    """Counts the routed MLP's assignments and the ones dropped past an
    expert's capacity while active, decode calls (``lanes`` rows) apart
    from prefill calls; the sums stay on the device until read."""

    def __init__(self, lanes: int, device):
        self.lanes, self.device = lanes, device

    def __enter__(self):
        self._orig = moe_lib.route
        self.kept = {k: torch.zeros((), dtype=torch.int64, device=self.device)
                     for k in ("decode", "prefill")}
        self.total = {"decode": 0, "prefill": 0}

        def counted(p, c, xf):
            r = self._orig(p, c, xf)
            kind = "decode" if xf.shape[0] == self.lanes else "prefill"
            self.kept[kind] += r.valid.sum()
            self.total[kind] += r.valid.numel()
            return r

        moe_lib.route = counted
        return self

    def __exit__(self, *exc):
        moe_lib.route = self._orig

    def dropped_share(self) -> dict:
        return {k: 1 - int(self.kept[k]) / self.total[k] if self.total[k] else None
                for k in self.total}


def moe_full_width(device) -> dict:
    """Phase 27: qwen3-moe-30b-a3b at its published widths, ``MOE_LAYERS``
    deep, through the engine, phase 19's traffic, K10 on its decode path."""
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated() / 2**30
    cfg = registry.get_config(MOE_ARCH).scaled(n_layers=MOE_LAYERS)
    model = registry.build_model(cfg)
    check(isinstance(model, moe_lib.MoELM) and model.device.type == "cuda",
          f"{MOE_ARCH} did not build as a MoELM on the card")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(model.specs(), torch.Generator(device=device).manual_seed(SEED), device,
                         torch.bfloat16)
    torch.cuda.synchronize()
    init_s, init_peak = time.perf_counter() - t0, torch.cuda.max_memory_allocated() / 2**30
    n_params = param_count(model.specs())
    print(f"{MOE_ARCH}: {n_params} parameters ({n_params * 2 / 2**30:.3f} GiB bf16), "
          f"{cfg.n_layers} layers, d_model {cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads}, "
          f"{cfg.n_experts} experts top-{cfg.top_k}, d_ff {cfg.d_ff}, vocab {cfg.vocab}; "
          f"init on the card {init_s:.2f} s, peak {init_peak:.3f} GiB "
          f"({held:.3f} GiB held before)")
    ps = prompts(SERVE_REQUESTS, cfg.vocab, *PROMPT_LEN)
    obs_metrics.enable()
    try:
        torch.cuda.reset_peak_memory_stats()
        with GatherCount() as gathers:
            eng, reqs, counts, stats, wall = serve(model, params, EngineConfig(**SERVE), ps,
                                                   SERVE_NEW)
        peak = torch.cuda.max_memory_allocated() / 2**30
        check(eng._fused, "attention='auto' did not pick K10 for the MoE model on the card")
        k10_n = counts["kvc_decode_attention"]
        check(k10_n == cfg.n_layers * eng.steps and k10_n > 0,
              f"K10 launched {k10_n} times in {eng.steps} decode steps of {cfg.n_layers} layers")
        prefills = stats["prefill"]["count"]
        check(gathers.n == 4 * cfg.n_layers * prefills,
              f"{gathers.n} page gathers in {prefills} prefill calls: decode gathered pages")
        check(eng.check_kv_integrity(), "the MoE model's KV pool is not clean after the drain")
        steps, ticks, pool_bytes = eng.steps, eng.ticks, eng.pool.nbytes()
        toks = [r.out_tokens for r in reqs]
        del eng
        # The repeat, untimed, counts the drops and holds every K10 call to float64.
        with DropCount(SERVE["batch_slots"], device) as drops, K10Held() as held:
            _, again, again_counts, _, _ = serve(model, params, EngineConfig(**SERVE), ps,
                                                 SERVE_NEW)
        check([r.out_tokens for r in again] == toks,
              "a second identical MoE run gave other tokens (the combine is not deterministic)")
        check(drops.total["decode"] > 0 and drops.total["prefill"] > 0,
              f"the drop count saw no routed assignments ({drops.total}): route was not called "
              "through moe_lib.route")
        check(held.calls == again_counts["kvc_decode_attention"] == k10_n,
              f"{held.calls} K10 calls held, {again_counts['kvc_decode_attention']} launched in "
              f"the repeat, {k10_n} in the first run")
        plain_eng, plain, plain_counts, plain_stats, plain_wall = serve(
            model, params, EngineConfig(**SERVE, attention="xla"), ps, SERVE_NEW)
        del plain_eng
        check(plain_counts["kvc_decode_attention"] == 0, "attention='xla' launched K10")
        check(all(a.out_tokens[0] == b[0] for a, b in zip(plain, toks)),
              "first tokens (from prefill) differ between attention auto and xla")
        rest = [(a, b) for r, tk in zip(plain, toks) for a, b in zip(r.out_tokens[1:], tk[1:])]
        agree = sum(a == b for a, b in rest) / len(rest)
        profiled = tick_profile(model, params, ps, ticks=2)  # ~8000 launches a tick
    finally:
        obs_metrics.disable()
        obs_metrics.reset()
    pre, tick = stats["prefill"], stats["tick"]
    decode_s = tick["mean"] * tick["count"] - pre["mean"] * pre["count"]
    out = {"params": n_params, "steps": steps, "ticks": ticks, "k10_launches": k10_n,
           "page_gathers": gathers.n, "prefill_calls": pre["count"],
           "prefill_ms_mean": pre["mean"] * 1e3, "prefill_ms_max": pre["max"] * 1e3,
           "tick_ms_median": tick["p50"] * 1e3,
           "decode_tokens_per_s": SERVE_REQUESTS * (SERVE_NEW - 1) / decode_s, "wall_s": wall,
           "dropped_share": drops.dropped_share(),
           "assignments": drops.total, "k10_held": held.summary(), "pool_bytes": pool_bytes, "peak_gib": peak,
           "init_peak_gib": init_peak, "xla_tick_ms_median": plain_stats["tick"]["p50"] * 1e3,
           "xla_wall_s": plain_wall, "xla_agree_after_first": agree,
           "prompt_tokens": sum(len(p) for p in ps)}
    print(f"serving {MOE_ARCH} full width (auto = K10): " + json.dumps(out))
    print("MoE decode tick profile (8 live lanes): " + json.dumps(profiled))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return {"kvc_decode_attention": k10_n}


def serial_family(arch: str, device) -> dict:
    """Phase 28a: an arch without prefill or paged pool at its published
    widths through the engine's token-by-token fallback, run twice."""
    cfg = registry.get_config(arch)
    model = registry.build_model(cfg)
    params = init_params(model.specs(), torch.Generator(device=device).manual_seed(SEED), device,
                         torch.bfloat16)
    ps = prompts(SERIAL_REQUESTS, cfg.vocab, *SERIAL_PROMPT)
    obs_metrics.enable()
    try:
        torch.cuda.reset_peak_memory_stats()
        eng, reqs, counts, stats, wall = serve(model, params, EngineConfig(**SERIAL), ps,
                                               SERIAL_NEW)
        peak = torch.cuda.max_memory_allocated() / 2**30
        check(not eng.paged and not eng._can_prefill and not eng._fused,
              f"{arch}: the engine took a paged, prefill or K10 path")
        check(counts["kvc_decode_attention"] == 0, f"{arch}: K10 launched")
        check(eng.check_kv_integrity(), f"{arch}: a free lane's state is not zero after the drain")
        _, again, _, _, _ = serve(model, params, EngineConfig(**SERIAL), ps, SERIAL_NEW)
        check([r.out_tokens for r in again] == [r.out_tokens for r in reqs],
              f"{arch}: a second identical run gave other tokens")
    finally:
        obs_metrics.disable()
        obs_metrics.reset()
    n_params = param_count(model.specs())
    out = {"params": n_params, "gib_bf16": n_params * 2 / 2**30, "steps": eng.steps,
           "tick_ms_median": stats["tick"]["p50"] * 1e3,
           "tokens_per_s": (sum(len(p) for p in ps) + SERIAL_REQUESTS * SERIAL_NEW) / wall,
           "wall_s": wall, "peak_gib": peak}
    print(f"serving {arch} full width, token by token: " + json.dumps(out))
    return out


def whisper_full_width(device) -> int:
    """Phase 28c: whisper-base's encoder over 1500 random frames for 8 lanes,
    then greedy decode with a (B,) index through K10's dense entry (D = 64)
    and through plain attention; the untimed repeat holds every K10 call
    to float64 (:class:`K10Held`).  Returns K10's launches."""
    cfg = registry.get_config(WHISPER)
    model = registry.build_model(cfg)
    gen = torch.Generator(device=device).manual_seed(SEED)
    params = init_params(model.specs(), gen, device, torch.bfloat16)
    frames = torch.randn((WHISPER_LANES, cfg.encoder_len, cfg.d_model), generator=gen,
                         device=device).to(torch.bfloat16)
    codec = model_layers.KVCodecConfig("blockfloat8")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cache0 = model.init_cache(WHISPER_LANES, WHISPER_STEPS + 1, codec, params=params,
                              frames=frames)
    torch.cuda.synchronize()
    encode_ms = (time.perf_counter() - t0) * 1e3
    start = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab, WHISPER_LANES).astype(np.int32)).to(device)
    toks, launches, step_ms = {}, {}, {}
    for label, attention in (("fused", "fused"), ("fused again", "fused"), ("xla", "xla")):
        cache = {k: v.clone() for k, v in cache0.items()}
        tok, out = start, []
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        # The repeat, untimed, holds every K10 call to float64.
        with K10Held() if label == "fused again" else contextlib.nullcontext() as held:
            t0 = time.perf_counter()
            for t in range(WHISPER_STEPS):
                index = torch.full((WHISPER_LANES,), t, dtype=torch.int32, device=device)
                logits, cache = model.decode_step(params, cache, tok, index, codec,
                                                  attention=attention)
                tok = torch.argmax(logits, dim=-1).to(torch.int32)
                out.append(tok)
            torch.cuda.synchronize()
            step_ms[label] = (time.perf_counter() - t0) / WHISPER_STEPS * 1e3
        launches[label] = kernels.launch_counts()["kvc_decode_attention"]
        toks[label] = torch.stack(out, 1).cpu().tolist()
        if held is not None:
            check(held.calls == launches[label], f"whisper: {held.calls} K10 calls held, "
                  f"{launches[label]} launched")
            k10_held = held.summary()
    check(launches["fused"] == cfg.n_layers * WHISPER_STEPS,
          f"whisper: K10 launched {launches['fused']} times in {WHISPER_STEPS} steps of "
          f"{cfg.n_layers} layers")
    check(launches["xla"] == 0, "whisper: attention='xla' launched K10")
    check(toks["fused again"] == toks["fused"], "whisper: a repeated K10 decode gave other tokens")
    check(all(a[0] == b[0] for a, b in zip(toks["fused"], toks["xla"])),
          "whisper: first tokens differ between K10 and plain attention")
    pairs = [(a, b) for x, y in zip(toks["fused"], toks["xla"]) for a, b in zip(x[1:], y[1:])]
    out = {"params": param_count(model.specs()), "encode_and_memory_ms": encode_ms,
           "decode_step_ms": step_ms, "k10_launches": launches["fused"], "k10_held": k10_held,
           "xla_agree_after_first": sum(a == b for a, b in pairs) / len(pairs)}
    print(f"{WHISPER} full width, {cfg.encoder_len} frames x {WHISPER_LANES} lanes: "
          + json.dumps(out))
    return launches["fused"] + launches["fused again"]


def family_inputs(cfg, seed: int = SEED):
    rng = np.random.default_rng(seed)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, size=(2, 16)).astype(np.int32))
    frames = (torch.from_numpy(rng.normal(size=(2, cfg.encoder_len, cfg.d_model))
                               .astype(np.float32)).to(torch.bfloat16)
              if cfg.family == "audio" else None)
    return tokens, frames


def hymba_window(device) -> dict:
    """Phase 28b: one hymba-1.5b decode step at its published widths, in
    float32, over a blockfloat8 cache filled at random, two of three lanes
    past the 1024-token window.  Redrawing the positions a windowed layer
    drops leaves the card's logits bit for bit; redrawing the same positions
    of the global layers moves the lanes past the window.  Card against CPU
    layer by layer: the CPU's cache writes take the card's new K/V and each
    of its layers starts from the card's output of the layer before, so
    each layer's attention, SSD and layer output, and the logits, are held
    from the same inputs within ``HYMBA_REL`` of their largest magnitude.
    (End to end the two part further: the codec's rounding is a step
    function, and 32 layers of random weights amplify a 1e-7 difference;
    that distance is printed.)"""
    cfg = dataclasses.replace(registry.get_config(HYMBA), dtype="float32")
    model = registry.build_model(cfg)
    gen = torch.Generator(device=device).manual_seed(SEED)
    params = init_params(model.specs(), gen, device, torch.float32)
    codec = model_layers.KVCodecConfig("blockfloat8")
    b, s = len(HYMBA_INDEX), max(HYMBA_INDEX) + 30

    def redraw(cache, layers, lane, stop):
        for name, leaf in cache.items():
            if not name.startswith("attn_"):
                continue
            part = leaf[layers, lane, :stop]
            if leaf.dtype == torch.int8:
                new = torch.randint(-127, 128, part.shape, generator=gen, device=device,
                                    dtype=torch.int8)
            else:  # per-(token, head) scales
                new = torch.rand(part.shape, generator=gen, device=device) * 1.9e-2 + 1e-3
            leaf[layers, lane, :stop] = new

    cache = model.init_cache(b, s, codec)
    redraw(cache, slice(None), slice(None), s)
    cache["ssd_state"].copy_(torch.randn(cache["ssd_state"].shape, generator=gen,
                                         device=device) * 0.1)
    rng = np.random.default_rng(SEED)
    token = torch.from_numpy(rng.integers(0, cfg.vocab, b).astype(np.int32))
    index = torch.from_numpy(np.asarray(HYMBA_INDEX, np.int32))

    def step(m, p, c, dev):
        c = {k: v.clone() for k, v in c.items()}
        logits, _ = m.decode_step(p, c, token.to(dev), index.to(dev), codec)
        return logits.float()

    def pinned_step(m, p, c, dev, pins=None):
        """``step`` recording every cache write's K/V and every layer's
        (attention, SSD, layer) output; given ``pins`` (another device's
        record), writes take its K/V and each layer continues from its
        layer output."""
        writes, outs = [], []
        orig_update = model_layers.cache_update

        def update(cache_, codec_, k, v, idx):
            if pins is not None:
                k, v = (t.to(k.device) for t in pins["writes"][len(writes)])
            writes.append((k.cpu(), v.cpu()))
            return orig_update(cache_, codec_, k, v, idx)

        def fuse(lp, x, a_out, s_out):
            y = type(m)._fuse(m, lp, x, a_out, s_out)
            outs.append(tuple(t.float().cpu() for t in (a_out, s_out, y)))
            return y if pins is None else pins["layers"][len(outs) - 1][2].to(y.device, y.dtype)

        model_layers.cache_update, m._fuse = update, fuse
        try:
            logits = step(m, p, c, dev)
        finally:
            model_layers.cache_update = orig_update
            del m._fuse
        return {"writes": writes, "layers": outs, "logits": logits.cpu()}

    kernels.reset_launch_counts()
    base = step(model, params, cache, device)
    windows = model._windows()
    local = [i for i, w in enumerate(windows) if w < s]
    wide = [i for i, w in enumerate(windows) if w >= s]
    globals_ = {0, cfg.n_layers // 2, cfg.n_layers - 1}
    check(local and wide == sorted(globals_) and len({windows[i] for i in local}) == 1,
          f"hymba windows {windows}: not global first, middle and last layers, the rest one window")
    past = [lane for lane, i in enumerate(HYMBA_INDEX) if i >= windows[local[0]]]
    blind, seen = ({k: v.clone() for k, v in cache.items()} for _ in range(2))
    for lane in past:
        stop = HYMBA_INDEX[lane] - windows[local[0]] + 1  # positions <= index - window
        redraw(blind, local, lane, stop)
        redraw(seen, wide, lane, stop)
    blind_logits, seen_logits = step(model, params, blind, device), step(model, params, seen,
                                                                           device)
    check(kernels.launch_counts()["kvc_decode_attention"] == 0, "hymba: K10 launched")
    check(torch.equal(blind_logits, base),
          "hymba: positions outside a windowed layer's window moved the logits")
    moved = [float((seen_logits[lane] - base[lane]).abs().max()) for lane in range(b)]
    card = pinned_step(model, params, cache, device)
    check(torch.equal(card["logits"], base.cpu()), "hymba: recording changed the card's step")
    cpu_dev = torch.device("cpu")
    cpu_model = registry.build_model(cfg, device=cpu_dev)
    cpu_params, cpu_cache = on_device(params, cpu_dev), on_device(cache, cpu_dev)
    cpu = pinned_step(cpu_model, cpu_params, cpu_cache, cpu_dev, pins=card)

    def rel(a, b_):
        return float((a - b_).abs().max()) / max(float(a.abs().max()), 1e-30)

    held = {f"{what} {kind}": max(rel(x[i], y[i]) for n, (x, y) in enumerate(
                zip(card["layers"], cpu["layers"])) if (n in local) == (kind == "windowed"))
            for i, what in enumerate(("attention", "ssd", "layer"))
            for kind in ("windowed", "global")}
    held["logits"] = rel(card["logits"], cpu["logits"])
    check(len(cpu["layers"]) == cfg.n_layers and all(v <= HYMBA_REL for v in held.values()),
          f"hymba at width past the window, card vs CPU layer by layer (bar {HYMBA_REL}): {held}")
    scale = float(base.abs().max())
    check(all(moved[lane] > HYMBA_REL * scale for lane in past) and moved[-1] == 0.0,
          f"hymba: redrawing the global layers' early positions moved the logits by {moved}")
    free = rel(base.cpu(), step(cpu_model, cpu_params, cpu_cache, cpu_dev))
    out = {"index": list(HYMBA_INDEX), "cache_len": s, "window": windows[local[0]],
           "windowed_layers": len(local), "card_vs_cpu_per_layer_rel": held,
           "card_vs_cpu_end_to_end_rel": free, "logit_scale": scale,
           "global_redraw_moved": moved}
    print(f"{HYMBA} full width, float32, one decode step past the window: " + json.dumps(out))
    return out


HYMBA_SERVED = dict(layers=4, prompt=1100, new=32)  # layer 1 of 4 is windowed (1024)


class PinnedWrites:
    """While active, records every ``models.layers.cache_update`` call's new
    K/V (host copies), or, given another run's record, writes that run's
    K/V instead of the ones computed (in call order)."""

    def __init__(self, pins=None):
        self.pins, self.writes = pins, []

    def __enter__(self):
        self._orig = model_layers.cache_update

        def update(cache, codec, k, v, index):
            if self.pins is not None:
                check(len(self.writes) < len(self.pins), "pinned run wrote more than its record")
                k, v = (t.to(k.device) for t in self.pins[len(self.writes)])
            self.writes.append((k.to("cpu", copy=True), v.to("cpu", copy=True)))
            return self._orig(cache, codec, k, v, index)

        model_layers.cache_update = update
        return self

    def __exit__(self, *exc):
        model_layers.cache_update = self._orig


def hymba_served_past_window(device) -> dict:
    """Phase 32: one request of ``HYMBA_SERVED['prompt']`` tokens through
    the serving engine on the card (token by token, a dense cache with codec
    none) at hymba-1.5b's published widths cut to 4 layers (layer 1
    windowed at 1024, the others global), float32 weights drawn on the
    card, recording each tick's inputs, K/V writes and SSD state; then the
    ticks that choose the ``new`` tokens taken again by the CPU's
    ``decode_step`` from the same weights, each from the card's state
    before it (the cache the card had written, the tick's writes pinned to
    the card's K/V, the SSD state copied in), as phase 28b pins one step:
    unpinned, the random-weight request is chaotic, and two float32
    programs give other tokens within it.  Held: the engine took its
    token-by-token path and launched no K10, and the CPU's greedy tokens
    are the card's.  Prints the card's median tick ms and how far the
    compared ticks' logits lie apart (not held: at these widths the SSD
    states grow large and a tick's float32 rounding is ill conditioned, on
    the card and on the CPU alike)."""
    cfg = registry.get_config(HYMBA).scaled(n_layers=HYMBA_SERVED["layers"], dtype="float32")
    prompt, new = HYMBA_SERVED["prompt"], HYMBA_SERVED["new"]
    ecfg = EngineConfig(batch_slots=1, max_len=prompt + new + 8, codec="none")
    codec = model_layers.KVCodecConfig("none")
    model = registry.build_model(cfg)
    windows = model._windows()
    check([w < prompt for w in windows] == [False, True, False, False],
          f"hymba at {cfg.n_layers} layers: windows {windows}, not layer 1 windowed")
    params = init_params(model.specs(), torch.Generator(device=device).manual_seed(SEED), device,
                         torch.float32)
    req = prompts(1, cfg.vocab, prompt, prompt)
    decode, ticks = model.decode_step, []

    def recorded(params_, cache, token, index, *args, **kwargs):
        chooses = len(ticks) >= prompt - 1  # a tick whose logits choose a new token
        state = cache["ssd_state"].to("cpu", copy=True) if chooses else None
        lg, cache = decode(params_, cache, token, index, *args, **kwargs)
        ticks.append((token.to("cpu", copy=True), index.to("cpu", copy=True), state,
                      lg[0].float().to("cpu", copy=True) if chooses else None))
        return lg, cache

    model.decode_step = recorded
    obs_metrics.enable()
    try:
        with PinnedWrites() as card:
            eng, reqs, counts, stats, wall = serve(model, params, ecfg, req, new)
    finally:
        obs_metrics.disable()
        obs_metrics.reset()
    check(not eng.paged and not eng._can_prefill and not eng._fused,
          "hymba: the engine took a paged, prefill or K10 path")
    check(counts["kvc_decode_attention"] == 0, "hymba: K10 launched")
    tokens = reqs[0].out_tokens
    layers, first = cfg.n_layers, prompt - 1  # tick ``prompt - 1`` chooses the first new token
    check(len(ticks) == eng.steps == prompt + new - 1 and len(card.writes) == layers * len(ticks),
          f"hymba: {len(ticks)} ticks and {len(card.writes)} writes for {prompt} + {new} tokens")
    cpu = torch.device("cpu")
    cpu_params = on_device(params, cpu)
    del model, params, eng
    free_card()
    cpu_model = registry.build_model(cfg, device=cpu)
    cache = cpu_model.init_cache(1, ecfg.max_len, codec)
    for t in range(first):  # the positions the card wrote before the first compared tick
        for i in range(layers):
            model_layers.cache_update({"k": cache["attn_k"][i], "v": cache["attn_v"][i]}, codec,
                                      *card.writes[t * layers + i], ticks[t][1])
    got, rel = [], []
    for t in range(first, len(ticks)):
        token, index, state, card_logits = ticks[t]
        cache["ssd_state"].copy_(state)
        with PinnedWrites(card.writes[t * layers:(t + 1) * layers]):
            lg, cache = cpu_model.decode_step(cpu_params, cache, token, index, codec)
        got.append(int(torch.argmax(lg[0])))
        rel.append(float((card_logits - lg[0]).abs().max() / card_logits.abs().max()))
    check(got == tokens, f"hymba past its window: card tokens {tokens}, CPU {got}")
    out = {"ticks": len(ticks), "tick_ms_median": stats["tick"]["p50"] * 1e3, "wall_s": wall,
           "window": cfg.window, "prompt": prompt, "new": new, "tokens": tokens,
           "logits_rel_max": max(rel), "logits_rel": rel}
    print(f"{HYMBA} at {cfg.n_layers} layers, float32, one request past the window "
          f"({card_line()}): " + json.dumps(out))
    return {}


def families_card_vs_cpu(device) -> int:
    """Phase 28d: each new family at SMOKE size, the same bf16 parameters on
    the card and on the CPU: forward logits, then 8 blockfloat8 decode
    steps with a (B,) index (K10 where the model has the route, its plain
    version on the CPU), every step's logits held.  The bar is
    ``SMOKE_ULPS`` bf16 ulps of the CPU's largest |logit|.  Returns K10's
    launches."""
    k10 = 0
    worst = {}
    for arch in FAMILY_SMOKE:
        cfg = registry.get_config(arch, smoke=True)
        specs = registry.build_model(cfg, device="cpu").specs()
        params = init_params(specs, torch.Generator().manual_seed(SEED), "cpu", torch.bfloat16)
        tokens, frames = family_inputs(cfg)
        codec = model_layers.KVCodecConfig("blockfloat8")
        got = {}
        for dev in (device, torch.device("cpu")):
            model = registry.build_model(cfg, device=dev)
            p = on_device(params, dev)
            extra = () if frames is None else (frames.to(dev),)
            with torch.no_grad():
                logits = model.forward(p, tokens.to(dev), *extra).float().cpu()
            attention = "fused" if model.supports_fused_attention else "xla"
            cache = (model.init_cache(2, FAMILY_STEPS, codec, params=p, frames=extra[0])
                     if extra else model.init_cache(2, FAMILY_STEPS, codec))
            kernels.reset_launch_counts()
            steps = []
            for t in range(FAMILY_STEPS):
                index = torch.full((2,), t, dtype=torch.int32, device=dev)
                step, cache = model.decode_step(p, cache, tokens[:, t].to(dev), index, codec,
                                                attention=attention)
                steps.append(step)
            n = kernels.launch_counts()["kvc_decode_attention"]
            want_n = (FAMILY_STEPS * cfg.n_layers if (dev.type == "cuda" and attention == "fused")
                      else 0)
            check(n == want_n, f"{arch} SMOKE on {dev.type}: K10 launched {n} times, not {want_n}")
            k10 += n
            got[dev.type] = (logits, torch.stack(steps).float().cpu())
        for i, what in enumerate(("forward", "decode")):
            a, b = got[device.type][i], got["cpu"][i]
            scale = float(b.abs().max())
            bar = SMOKE_ULPS * bf16_ulp(scale)
            diff = float((a - b).abs().max())
            check(diff <= bar, f"{arch} SMOKE {what} logits: card and CPU differ by {diff} "
                  f"(bar {SMOKE_ULPS} bf16 ulps of {scale}: {bar})")
            worst[f"{arch} {what}"] = [diff, bar]
    print(f"SMOKE card vs CPU ([max |logit difference|, bar = {SMOKE_ULPS} bf16 ulps of the "
          f"largest |logit|], bf16; decode over {FAMILY_STEPS} steps): " + json.dumps(worst))
    return k10


def other_families(device) -> dict:
    """Phase 28: rwkv6 and hymba at their published widths, whisper-base's
    encoder and K10 decode, and the five new archs card against CPU."""
    for arch in SERIAL_ARCHS:
        serial_family(arch, device)
        gc.collect()
        torch.cuda.empty_cache()
    hymba_window(device)
    gc.collect()
    torch.cuda.empty_cache()
    k10 = whisper_full_width(device)
    gc.collect()
    torch.cuda.empty_cache()
    return {"kvc_decode_attention": k10 + families_card_vs_cpu(device)}


# ------------------------------------- the dry run against the card (phase 29) -----

DRYRUN_PEAK_TOL = 0.10  # |predicted / measured peak - 1| (PERF.md, written before the first run)
# (arch, batch, length) of the train steps: (a) phase 23's shape; (b) the
# other families, cut to a length whose meta trace fits the phase's time
# (rwkv6's and hymba's Python chunk loops cost host time per operation)
DRYRUN_TRAIN = (("minicpm-2b", TRAIN_BATCH, TRAIN_SEQ), ("rwkv6-1.6b", 8, 128),
                ("hymba-1.5b", 8, 128), ("whisper-base", 8, 128))
DRYRUN_DECODE = ("starcoder2-3b", "decode_32k")  # (c): its single-mesh card cell
DRYRUN_ROWS = registry.SHAPES["decode_32k"].global_batch // dryrun.SINGLE_POD[0]  # 8
DRYRUN_CLI = (("whisper-base", "train_4k"), ("whisper-base", "prefill_32k"),
              ("starcoder2-3b", "decode_32k"))  # (d): one cell of each kind
DRYRUN_DIR = SNAPSHOT_DIR.parent / ".chip_smoke_dryrun"  # gitignored; removed at the end


def random_batch(cfg, shape, seed: int = SEED) -> dict:
    """A host batch of ``input_specs``' shapes and dtypes: tokens and labels
    uniform over the vocabulary, frames and prefixes standard normal."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in registry.input_specs(cfg, shape).items():
        if v.dtype == torch.int32:
            out[k] = torch.from_numpy(rng.integers(0, cfg.vocab, size=v.shape, dtype=np.int32))
        else:
            out[k] = torch.from_numpy(rng.standard_normal(v.shape, dtype=np.float32)).to(v.dtype)
    return out


def free_card() -> int:
    """Bytes still allocated once everything unreferenced is freed."""
    gc.collect()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated()


def hold_prediction(label: str, pred: dict, trace_s: float, flops: float, held: int,
                    ms: float) -> dict:
    """Phase 29's check of one cell: the meta FLOPs equal the card's, the
    predicted peak within ``DRYRUN_PEAK_TOL`` of the card's (both over what
    was allocated before the cell's state)."""
    peak = torch.cuda.max_memory_allocated() - held
    ratio = pred["peak"] / peak
    row = {"predicted_peak_bytes": pred["peak"], "measured_peak_bytes": peak,
           "predicted_peak_gib": pred["peak"] / 2**30, "measured_peak_gib": peak / 2**30,
           "ratio": ratio, "argument_gib": pred["argument_bytes"] / 2**30,
           "flops_meta": pred["flops"], "flops_card": flops, "step_ms": ms,
           "tflops_per_s": flops / ms / 1e9, "trace_s": trace_s}
    print(f"dry run vs card, {label} ({card_line()}): " + json.dumps(row))
    check(flops == pred["flops"], f"{label}: meta counts {pred['flops']} FLOPs, the card {flops}")
    check(abs(ratio - 1) <= DRYRUN_PEAK_TOL,
          f"{label}: predicted peak {pred['peak']} B against the card's {peak} B "
          f"(ratio {ratio:.4f}, tolerance {DRYRUN_PEAK_TOL})")
    return row


def dryrun_train(arch: str, batch: int, seq: int, device) -> dict:
    """Phase 29a/b: one train step (f32 state, the config's compute dtype,
    one rank) predicted on meta, then run on the card twice: the first
    under ``FlopCounterMode``, the second timed."""
    cfg = registry.get_config(arch)
    shape = registry.ShapeCell("phase29", seq, batch, "train")
    t0 = time.perf_counter()
    pred = dryrun.train_cost(registry.build_model(cfg, device="meta"), cfg, shape, None, 1, 1,
                             param_dtype=torch.float32)
    trace_s = time.perf_counter() - t0
    model = registry.build_model(cfg)
    scfg = step_lib.TrainStepConfig()
    held = free_card()
    state = step_lib.init_state(model, None, torch.Generator(device=device).manual_seed(SEED),
                                scfg)
    step = step_lib.build_train_step(model, None, scfg, extra_keys=dryrun.extra_keys(cfg))
    host = random_batch(cfg, shape)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with FlopCounterMode(display=False) as counter:
        state, m1 = step(state, host)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, m2 = step(state, host)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    losses = [float(m1["loss"]), float(m2["loss"])]
    check(all(math.isfinite(v) for v in losses), f"{arch} train step losses {losses}")
    row = hold_prediction(f"{arch} train {batch} x {seq}", pred, trace_s,
                          float(counter.get_total_flops()), held, ms)
    del state, step, m1, m2
    free_card()
    return dict(row, losses=losses)


def dryrun_decode(device) -> dict:
    """Phase 29c: starcoder2-3b's decode step at decode_32k's single-mesh
    card cell (8 rows, a 32768-position cache, codec none), every lane at
    the last position."""
    arch, shape_name = DRYRUN_DECODE
    cfg = registry.get_config(arch)
    shape = dataclasses.replace(registry.SHAPES[shape_name], global_batch=DRYRUN_ROWS)
    t0 = time.perf_counter()
    pred = dryrun.decode_cost(registry.build_model(cfg, device="meta"), cfg, shape, None)
    trace_s = time.perf_counter() - t0
    model = registry.build_model(cfg)
    codec = model_layers.KVCodecConfig("none")
    held = free_card()
    params = init_params(model.specs(), torch.Generator(device=device).manual_seed(SEED), device,
                         torch.bfloat16)
    cache = model.init_cache(DRYRUN_ROWS, shape.seq_len, codec)
    token = torch.randint(0, cfg.vocab, (DRYRUN_ROWS,), dtype=torch.int32, device=device,
                          generator=torch.Generator(device=device).manual_seed(SEED))
    index = torch.full((DRYRUN_ROWS,), shape.seq_len - 1, dtype=torch.int32, device=device)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with FlopCounterMode(display=False) as counter:
        logits, _ = model.decode_step(params, cache, token, index, codec, attention="xla")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again, _ = model.decode_step(params, cache, token, index, codec, attention="xla")
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    check(tuple(logits.shape) == (DRYRUN_ROWS, cfg.padded_vocab)
          and bool(torch.isfinite(logits).all()) and torch.equal(logits, again),
          f"{arch} decode logits: shape {tuple(logits.shape)}, finite and repeatable")
    row = hold_prediction(f"{arch} decode {DRYRUN_ROWS} rows x {shape.seq_len}", pred, trace_s,
                          float(counter.get_total_flops()), held, ms)
    del params, cache, logits, again
    free_card()
    return row


def dryrun_clis(decode: dict) -> dict:
    """Phase 29d: the dryrun and costrun CLIs on one cell of each kind into
    a scratch folder; every cell ``ok``, and the CLI's decode cell lies on
    the unfolded (16, 16) mesh and fits (it is the sharded serving step,
    whose trace phase 31 holds on the card; 29c's one-card cell is
    ``decode_cost`` without a mesh)."""
    out = {}
    for arch, shape in DRYRUN_CLI:
        for name, mod in (("dryrun", dryrun), ("costrun", costrun)):
            t0 = time.perf_counter()
            rc = mod.main(["--arch", arch, "--shape", shape, "--out", str(DRYRUN_DIR / name)])
            cell = json.loads((DRYRUN_DIR / name / f"{arch}__{shape}__single.json").read_text())
            check(rc == 0 and cell["status"] == "ok", f"{name} {arch} {shape}: rc {rc}, {cell}")
            out[f"{name} {arch} {shape}"] = {
                "wall_s": time.perf_counter() - t0, "flops_per_device": cell["flops_per_device"],
                "peak_bytes": cell.get("peak_bytes_per_device"),
                "fits_device": cell.get("fits_device"), "microbatches": cell.get("microbatches")}
    cli = json.loads((DRYRUN_DIR / "dryrun" / f"{'__'.join(DRYRUN_DECODE)}__single.json"
                      ).read_text())
    check(cli["mesh_shape"] == {"data": 16, "model": 16} and cli["fits_device"]
          and cli["peak_bytes_per_device"] < decode["predicted_peak_bytes"],
          f"the dryrun CLI's decode cell ({cli['mesh_shape']}, {cli['peak_bytes_per_device']} B) "
          f"is not the sharded step's on (16, 16) below 29c's one-card peak")
    print("dryrun and costrun CLIs (one cell of each kind, single mesh): " + json.dumps(out))
    return out


def dryrun_vs_card(device) -> dict:
    """Phase 29: the dry run against the card (module docstring)."""
    check(torch.cuda.get_device_properties(0).total_memory == dryrun.DEVICE_MEMORY_BYTES,
          f"the card's total_memory {torch.cuda.get_device_properties(0).total_memory} is not "
          f"dryrun.DEVICE_MEMORY_BYTES {dryrun.DEVICE_MEMORY_BYTES}")
    kernels.reset_launch_counts()
    try:
        for arch, batch, seq in DRYRUN_TRAIN:
            dryrun_train(arch, batch, seq, device)
        dryrun_clis(dryrun_decode(device))
    finally:
        shutil.rmtree(DRYRUN_DIR, ignore_errors=True)
    launched = {k: v for k, v in kernels.launch_counts().items() if v}
    check(not launched, f"phase 29 launched kernels: {launched} (no kernel is on its path)")
    return {}


# ---------------------------- the sharded train step on model blocks (phase 30) -----

STEP_DIR = SNAPSHOT_DIR.parent / ".chip_smoke_sharded_step"  # gitignored; removed at the end
# published widths, depth cut to 1 layer: at 2 layers phi3.5-moe's step took
# 47.5-49.3 s (gloo through the host), too long for this script's time limit.
# phi3.5-moe: 32 q and 8 kv heads split 16 and 4 per rank, 16 experts 8 per
# rank; minicpm-2b: 36 heads split 18 per rank, dense SwiGLU, the tied
# 122,753 x 2304 table vocab-parallel; rwkv6-1.6b: 32 wkv heads split 16 a
# rank (column-parallel r, k, v, g, row-parallel wo), d_ff 3584 a rank;
# hymba-1.5b: 25 attention and 25 SSD heads replicated (25 does not divide
# over 2), the MLP 2752 a rank, the 32,256-row tables vocab-parallel
STEP_ARCHS = ("phi3.5-moe-42b-a6.6b", "minicpm-2b", "rwkv6-1.6b", "hymba-1.5b")
STEP_LAYERS = 1
STEP_SNAPSHOT_ARCH = "phi3.5-moe-42b-a6.6b"  # the in-situ snapshot of the sharded params
STEP_MESH = {"data": 2, "model": 2}  # 4 gloo ranks on cuda:0; a fifth runs the replicated step
STEP_BATCH, STEP_SEQ, STEP_STEPS, STEP_LR = 8, 256, 3, 1e-3
STEP_EB = 1e-3  # the in-situ snapshot's absolute bound
STEP_MIN_BYTES = 1 << 20  # leaves below this stay out of the snapshot and are saved raw
# The sharded run against the replicated one, at the CPU twin's tolerances
# (the loss widened for 4096-wide contractions), on every step.  The
# replicated rank is teacher-forced on the gradient: at each step it takes
# its own loss and gradient from its own state, holds them against the
# sharded run's, then applies AdamW with the sharded run's gradient and
# norm, so both runs enter every step with the same parameters, m and v.
# AdamW divides each gradient element by its own root mean square, so an
# element whose gradient is at rounding level takes its step's sign from
# the rounding (up to 2 lr apart); forcing keeps that amplification out,
# and the sharded computation is held where it acts, on the gradient.  Two
# float32 programs of one step part where the step amplifies rounding (on
# the H100 at this phase's widths the query and key gradients of either run
# lie about 2e-4 of their norm from float64, through the attention scores'
# backward), so each float32 gradient is held against a float64
# evaluation of the same step at the same parameters (:func:`float64_model`):
# each leaf's sharded gradient lies within ``STEP_F32_FACTOR`` times the
# replicated float32 gradient's distance from it, in L2 and in its largest
# element (a missing or doubled reduction moves a leaf by half its norm or
# more, a misplaced block by its whole size, one of the 2048 tokens handled
# wrong by about 1/sqrt(2048) of the leaves it reaches); the gradient norm
# likewise (the two float32 norms part by up to 1.6e-5, each 0.7e-5 to
# 3.1e-5 from the float64 one), against the larger of the replicated norm's
# distance at the step and its root mean square over the phase's steps: the
# norm is one scalar, so one step's distance is one draw of the float32
# rounding and can land near zero (phi3.5-moe's third step on Megatron
# blocks: 5.8e-7 relative, against 1.16e-5 and 1.33e-5 at the first two),
# and four times that bounds nothing.  Also held: losses within ``loss_rtol``,
# and the replicated rank's norm of the sharded gradient's values against
# the sharded norm over blocks within ``norm_rtol``.  At
# the end the state, the same update of the same inputs on blocks and on
# whole leaves, is held element by element: every parameter within
# ``param_atol``, every element of m and v within ``mv_rtol``.
STEP_TOL = {"loss_rtol": 1e-5, "param_atol": 1e-5, "mv_rtol": 1e-2, "norm_rtol": 1e-5}
STEP_F32_FACTOR = 4.0
STEP_RANKS = math.prod(STEP_MESH.values())
# cuBLAS and cuBLASLt workspaces of the forward and the autograd threads, 32
# MiB each, and room for small buffers
STEP_WORKSPACE_MAX = 5 * 32 * 2**20


def step_cfg(arch: str):
    cfg = registry.get_config(arch).scaled(n_layers=STEP_LAYERS, dtype="float32")
    scfg = step_lib.TrainStepConfig(peak_lr=STEP_LR, warmup_steps=1, total_steps=10)
    return cfg, scfg


def step_batches(cfg) -> list:
    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=STEP_SEQ, global_batch=STEP_BATCH,
                                    seed=SEED))
    return [pipe.batch_at(i) for i in range(STEP_STEPS)]


def step_prediction(arch: str) -> dict:
    """The dry run's counters for one sharded step of ``arch`` on rank 0 of
    the same mesh: a fake process group of ``STEP_RANKS``, the state and the
    step on ``meta``; ``by_axis``: the bytes the step's collectives send,
    by kind and mesh axis (``spmd.sent_by_axis``)."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore  # registers "fake"

    cfg, scfg = step_cfg(arch)
    t0 = time.perf_counter()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=STEP_RANKS)
    try:
        mesh = init_device_mesh("cpu", tuple(STEP_MESH.values()),
                                mesh_dim_names=tuple(STEP_MESH))
        model = registry.build_model(cfg, device="meta")
        state = step_lib.empty_state(model, mesh, scfg)
        step = step_lib.build_train_step(model, mesh, scfg)
        batch = dryrun.host_batch({k: model_layers.TensorSpec((STEP_BATCH, STEP_SEQ), torch.int32)
                                   for k in ("tokens", "labels")})
        spmd.reset_sent_bytes()
        pred = dryrun.measure(lambda: step(state, batch), state)
        pred["by_axis"] = sent_by_axis()
    finally:
        dist.destroy_process_group()
    pred["trace_s"] = time.perf_counter() - t0
    return pred


def sent_by_axis() -> dict:
    """``spmd.sent_by_axis`` without its empty kinds."""
    return {k: dict(v) for k, v in spmd.sent_by_axis.items() if v}


def step_start(port: int) -> list:
    """Phase 30's group: ``STEP_RANKS`` sharded ranks and one replicated
    rank, each this script with ``--step-rank``, all on cuda:0."""
    STEP_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for rank in range(STEP_RANKS + 1):
        log = open(STEP_DIR / f"r{rank}.log", "w")
        procs.append(subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--step-rank", str(rank),
             str(STEP_RANKS + 1), str(port), str(STEP_DIR)], stdout=log,
            stderr=subprocess.STDOUT))
    CHILD_PROCS.extend(procs)
    return procs


def _timed_steps(step, state, batches) -> tuple:
    """Run the steps: the first under ``FlopCounterMode`` with the peak
    counted from its start, the others timed (each ended by a
    ``synchronize``).  Returns the state and a record: losses, gradient
    norms, rates, FLOPs and peak of the first step, ms of the others and
    the bytes this rank sent in the second.  The peak is the step's: what
    stays allocated after it beyond the state's blocks (the cuBLAS and
    cuBLASLt workspaces of the forward and the autograd threads, made on
    their first products in a fresh process: 32 MiB each) is not the
    model's, and ``workspace`` records it."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    blocks = [sharding.local(x) for x in tree_util.tree_flatten(state)[0]]
    state_alloc = sum(dryrun.alloc_bytes(x.numel() * x.element_size()) for x in blocks)
    del blocks
    rec = {"losses": [], "norms": [], "lrs": [], "ms": [], "sent": {}}

    def keep(m):
        rec["losses"].append(float(m["loss"]))
        rec["norms"].append(float(m["grad_norm"]))
        rec["lrs"].append(float(m["lr"]))

    with FlopCounterMode(display=False) as counter:
        state, m = step(state, batches[0])
    keep(m)
    torch.cuda.synchronize()
    rec["workspace"] = torch.cuda.memory_allocated() - state_alloc
    rec["flops"] = float(counter.get_total_flops())
    rec["peak"] = torch.cuda.max_memory_allocated() - rec["workspace"]
    for i, b in enumerate(batches[1:]):
        spmd.reset_sent_bytes()
        insitu.reset_sent_bytes()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, b)
        keep(m)
        rec["ms"].append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            rec["sent"] = {**{f"step {k}": v for k, v in spmd.sent_bytes.items()},
                           **{f"loss {k}": v for k, v in insitu.sent_bytes.items() if v}}
            rec["by_axis"] = sent_by_axis()
    return state, rec


def _snapshot_and_restore(state, mesh, group, out: Path) -> dict:
    """One in-situ snapshot of the params through ``build_insitu_hook``,
    restored with ``restore(shardings=)`` onto the same mesh: lossy leaves
    within the bound, and every leaf of ``STEP_MIN_BYTES`` or more coded or
    named once as skipped (split over both axes, most leaves fit neither a
    flat arena nor the K8 tile buckets; the per-leaf path codes 1- to 3-D
    fields, with ``core`` SZ where the kernel backend wants 3-D ones); the
    leaves below ``STEP_MIN_BYTES`` saved raw by a manager and restored the
    same way, bitwise."""
    params = state["params"]
    named = dict(tree_util.tree_flatten_with_path({"params": params})[0])
    spec = lambda x: sharding.spec_of(x) if sharding.is_dtensor(x) else ()  # noqa: E731
    big = {k: v for k, v in named.items() if v.numel() * v.element_size() >= STEP_MIN_BYTES}
    hook = launch_train_lib.build_insitu_hook(mesh, str(out / "snap"), STEP_EB,
                                              min_bytes=STEP_MIN_BYTES, overlap=False)
    kernels.reset_launch_counts()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        hook(STEP_STEPS, {"params": params})
        hook.wait()
    snap_s = time.perf_counter() - t0
    launches = {k: v for k, v in kernels.launch_counts().items() if v}
    dist.barrier(group)  # the first rank's files are on disk
    # the snapshot's layout: the hook's plan, less the leaves it says it skips
    entries = [(k, tuple(v.shape), v.dtype, spec(v)) for k, v in big.items()]
    kb, rest = insitu.plan_kernel_buckets(entries, mesh)
    fb, skipped = insitu.plan_arena(rest, mesh)
    log = buf.getvalue()
    refused = [k for k, _ in skipped if f"skipping {k}:" in log]
    print(log, flush=True)
    like = {f"karena{i:03d}": dict.fromkeys(b.names, 0) for i, b in enumerate(kb)}
    like.update({f"arena{i:03d}": dict.fromkeys(b.names, 0) for i, b in enumerate(fb)})
    like.update({k: 0 for k, _ in skipped if k not in refused})
    to = lambda k: sharding.NamedSharding(mesh, spec(big[k]))  # noqa: E731
    t0 = time.perf_counter()
    got, _ = hook.manager.restore(STEP_STEPS, state_like=like, shardings={
        f: ({n: to(n) for n in v} if isinstance(v, dict) else to(f)) for f, v in like.items()})
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    lossy, worst = 0, 0.0
    for key, field in got.items():
        for name, block in (field.items() if isinstance(field, dict) else [(key, field)]):
            err = float((block.to_local().float() - sharding.local(big[name]).float()).abs().max())
            check(err <= STEP_EB * (1 + 1e-5), f"snapshot leaf {name}: error {err} > {STEP_EB}")
            lossy, worst = lossy + 1, max(worst, err)
    check(lossy + len(refused) == len(big),
          f"snapshot: {lossy} leaves coded and {len(refused)} named as skipped of {len(big)}")
    # the small leaves, raw
    small = {k: v for k, v in named.items() if v.numel() * v.element_size() < STEP_MIN_BYTES}
    raw = ckpt.CheckpointManager(out / "raw", async_save=False, device="cuda",
                                 group=dist.new_group(ranks=list(range(STEP_RANKS)),
                                                      backend="gloo"))
    raw.save(STEP_STEPS, small)
    dist.barrier(group)
    shard = {k: sharding.NamedSharding(mesh, sharding.spec_of(v) if sharding.is_dtensor(v)
                                       else ()) for k, v in small.items()}
    back, _ = raw.restore(STEP_STEPS, state_like=small, shardings=shard)
    for k, v in small.items():
        check(torch.equal(back[k].to_local().to(v.device), sharding.local(v)),
              f"raw leaf {k} did not restore bitwise")
    return {"lossy_leaves": lossy, "lossy_max_err": worst, "raw_leaves": len(small),
            "skipped_leaves": refused, "snapshot_leaves": len(big),
            "snapshot_s": snap_s, "restore_s": restore_s, "launches": launches}


def _rank_blocks(shape, spec, mesh) -> Iterator[tuple]:
    """``(rank, local shape, slices)`` of each sharded rank's block of a
    leaf of ``shape`` on ``spec``, in rank order."""
    local = sharding.local_shape(shape, spec, mesh)
    spec = tuple(spec) + (None,) * (len(local) - len(spec))
    axes = list(STEP_MESH)
    for r in range(STEP_RANKS):
        coord = np.unravel_index(r, tuple(STEP_MESH.values()))
        yield r, local, tuple(slice(0 if e is None else coord[axes.index(e)] * n,
                                    (0 if e is None else coord[axes.index(e)] * n) + n)
                              for e, n in zip(spec, local))


@contextlib.contextmanager
def float64_model(model):
    """``model`` computing in float64: its compute dtype, and the float32
    casts of the model modules (norms, RoPE, attention scores, routing, the
    loss, the wkv and SSD scans and states) made float64 through a stand-in
    for their ``torch``; restored on exit."""
    proxy = types.ModuleType("torch")
    proxy.__dict__.update(vars(torch))
    proxy.float32 = torch.float64
    mods = (model_layers, moe_lib, transformer_lib, rwkv6_lib, hybrid_lib)
    saved, dtype = [m.torch for m in mods], model.dtype
    for m in mods:
        m.torch = proxy
    model.dtype = torch.float64
    try:
        yield model
    finally:
        for m, t in zip(mods, saved):
            m.torch = t
        model.dtype = dtype


def float64_grads(model, params, batch) -> list:
    """The float64 gradient of the step's loss at ``params`` (float32
    leaves, promoted exactly) on ``batch``."""
    leaves, treedef = tree_util.tree_flatten(params)
    p64 = [x.detach().to(torch.float64).requires_grad_(True) for x in leaves]
    dev = p64[0].device
    with float64_model(model):
        loss = model.loss(tree_util.tree_unflatten(treedef, p64),
                          torch.as_tensor(batch["tokens"]).to(dev),
                          torch.as_tensor(batch["labels"]).to(dev))
        check(loss.dtype == torch.float64, f"the float64 loss came back {loss.dtype}")
        return list(torch.autograd.grad(loss, p64))


def _forced_grads(own: list, ref: list, paths: list, shards: list, mesh) -> tuple[list, dict]:
    """The replicated rank's side of one step's gradient: every sharded
    rank's block of each leaf, received over gloo in rank order and laid
    into a whole leaf.  Per leaf: the distance of the sharded and of this
    rank's own float32 gradient (``own``) from the float64 one (``ref``),
    in L2 and largest element, the leaf's float64 norm, and the sharded
    gradient's relative L2 from ``own``."""
    whole, stats = [], {}
    for g, r64, path, sh in zip(own, ref, paths, shards):
        out = torch.empty_like(g)
        e_rep = g.to(torch.float64) - r64
        st = {"rep_l2": float(e_rep.norm()), "rep_max": float(e_rep.abs().max()),
              "ref_l2": float(r64.norm()), "numel": g.numel()}
        del e_rep
        sh2 = d2 = 0.0
        sh_max, blocks = 0.0, 0
        for r, local, block in _rank_blocks(g.shape, sh.spec, mesh):
            buf = torch.empty(local, dtype=g.dtype)
            dist.recv(buf, src=r)
            got = buf.to(g.device)
            e = got.to(torch.float64) - r64[block]
            sh2 += float(torch.sum(e * e))
            sh_max = max(sh_max, float(e.abs().max()))
            d2 += float(torch.sum((got.to(torch.float64) - g[block]) ** 2))
            blocks += got.numel()
            out[block] = got
        share = g.numel() / blocks  # a block held by several ranks counts once
        st.update(sh_l2=math.sqrt(sh2 * share), sh_max=sh_max,
                  vs_rep=math.sqrt(d2 * share) / st["ref_l2"] if st["ref_l2"] else 0.0)
        stats[path] = st
        whole.append(out)
    return whole, stats


def _compare_state(state, parts, shards, mesh) -> dict:
    """The replicated rank's side of the end state: every sharded rank's
    block of each ``parts`` leaf (params, m, v), received over gloo in rank
    order, against the same slice of ``state``.  Per kind: the largest
    difference (absolute for params, relative for the moments), the
    elements outside ``STEP_TOL``, those not bitwise equal, and how many
    were compared."""
    flat = tree_util.tree_flatten(state)[0]
    out = {k: {"worst": 0.0, "over": 0, "unequal": 0, "count": 0}
           for k in ("params", "m", "v")}
    for i, (path, s) in parts:
        kind = ("params" if path.startswith("['params']")
                else "m" if path.startswith("['opt']['m']") else "v")
        for r, local, block in _rank_blocks(s.shape, shards[i].spec, mesh):
            buf = torch.empty(local, dtype=s.dtype)
            dist.recv(buf, src=r)
            want = flat[i][block]
            got = buf.to(want.device)
            d = (got - want).abs()
            if kind == "params":
                err, outside = d.max() if d.numel() else 0.0, d > STEP_TOL["param_atol"]
            else:
                err = (d / want.abs().clamp_min(1e-30)).max() if d.numel() else 0.0
                outside = d > STEP_TOL["mv_rtol"] * want.abs()
            o = out[kind]
            o["worst"] = max(o["worst"], float(err))
            o["over"] += int(outside.sum())
            o["unequal"] += int((got != want).sum())
            o["count"] += d.numel()
    return out


def step_worker(argv: list[str]) -> int:
    """One rank of :func:`step_start`'s group: each of ``STEP_ARCHS`` in
    turn (:func:`_step_arch`) on one mesh."""
    rank, world, port, out = int(argv[0]), int(argv[1]), argv[2], Path(argv[3])
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world,
                            rank=rank)
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from torch.distributed.device_mesh import DeviceMesh

    try:
        # collective over the world: the replicated rank takes part, outside the mesh
        mesh = DeviceMesh("cuda", torch.arange(STEP_RANKS).view(*STEP_MESH.values()),
                          mesh_dim_names=tuple(STEP_MESH))
        group = dist.new_group(ranks=list(range(STEP_RANKS)), backend="gloo")
        res = {arch: _step_arch(arch, rank, mesh, group, out) for arch in STEP_ARCHS}
        with open(out / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(res, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


def _step_arch(arch: str, rank: int, mesh, group, out: Path) -> dict:
    """One architecture of phase 30 on this rank.  Ranks ``0 ..
    STEP_RANKS - 1`` take the sharded steps on the ``STEP_MESH`` mesh
    (keeping host copies of each step's gradient blocks as AdamW receives
    them, and of their params, ``m`` and ``v`` blocks at the end), snapshot
    (``STEP_SNAPSHOT_ARCH``), then free the card; the last rank then takes
    the same steps replicated, alone on the card, teacher-forced on each
    step's sharded gradient and norm (``STEP_TOL``'s comment), and holds
    every block of every rank (sent over gloo) against its own gradient at
    each step and its own state at the end."""
    adamw = step_lib.adamw
    real_update, real_norm = adamw.apply_updates, adamw.global_norm
    res: dict = {}
    t_arch = time.perf_counter()
    cfg, scfg = step_cfg(arch)
    batches = step_batches(cfg)
    n = STEP_RANKS
    model = registry.build_model(cfg, device="cuda")
    state_abs, shard_tree = step_lib.make_state_specs(model, mesh, scfg)
    shards = tree_util.tree_flatten(shard_tree)[0]
    parts = [(i, s) for i, s in enumerate(tree_util.tree_flatten_with_path(state_abs)[0])
             if s[0].startswith(("['params']", "['opt']['m']", "['opt']['v']"))]
    g_paths = [p for p, _ in tree_util.tree_flatten_with_path(state_abs["params"])[0]]
    g_shards = tree_util.tree_flatten(shard_tree["params"])[0]

    if rank < n:
        grads_kept = []  # host copies of each step's gradient blocks

        def capture(params, opt_state, grads, lr, acfg):
            grads_kept.append([sharding.local(g).detach().cpu()
                               for g in tree_util.tree_flatten(grads)[0]])
            return real_update(params, opt_state, grads, lr, acfg)

        t0 = time.perf_counter()
        state = step_lib.init_state(model, mesh, torch.Generator(device="cuda").manual_seed(0),
                                    scfg)
        res["init_s"] = time.perf_counter() - t0
        flat = tree_util.tree_flatten(state)[0]
        res["shapes_ok"] = all(
            tuple(sharding.local(x).shape) == sharding.local_shape(s.shape, sh.spec, mesh)
            for x, (_, s), sh in zip(flat, tree_util.tree_flatten_with_path(state_abs)[0],
                                     shards))
        res["state_bytes"] = sum(sharding.local(x).numel() * sharding.local(x).element_size()
                                 for x in flat)
        del flat
        step = step_lib.build_train_step(model, mesh, scfg)
        adamw.apply_updates = capture
        try:
            state, rec = _timed_steps(step, state, batches)
        finally:
            adamw.apply_updates = real_update
        res.update(rec)
        flat = tree_util.tree_flatten(state)[0]
        kept = [sharding.local(flat[i]).detach().cpu() for i, _ in parts]
        del flat
        print(f"rank {rank}, {arch}: init {res['init_s']:.1f} s, losses {res['losses']}, "
              f"norms {res['norms']}, step ms {res['ms']}, peak {res['peak']}", flush=True)
        if arch == STEP_SNAPSHOT_ARCH:
            res["snapshot"] = _snapshot_and_restore(state, mesh, group, out)
        del state, step
        gc.collect()
        torch.cuda.empty_cache()
    elif arch == STEP_SNAPSHOT_ARCH:  # the groups the sharded ranks' snapshot creates
        for _ in range(3):  # build_insitu_hook's two, the raw manager's: collective over the world
            dist.new_group(ranks=list(range(n)), backend="gloo")
    dist.barrier()  # the sharded ranks' card memory is free
    if rank == n:
        forced: list = []

        def force(params, opt_state, grads, lr, acfg):
            """Hold this rank's gradient against the sharded run's, then
            update with the sharded run's gradient and norm."""
            t0 = time.perf_counter()
            own, gdef = tree_util.tree_flatten(grads)
            ref = float64_grads(model, params, batches[len(forced)])
            norm = torch.empty(1, dtype=torch.float32)
            dist.recv(norm, src=0)
            whole, stats = _forced_grads(own, ref, g_paths, g_shards, mesh)
            del ref
            g_sharded = tree_util.tree_unflatten(gdef, whole)
            rec = {"own_norm": float(real_norm(grads)), "sharded_norm": float(norm[0]),
                   "same_values_norm": float(real_norm(g_sharded)), "grads": stats,
                   "f64_norm": math.sqrt(sum(st["ref_l2"] ** 2 for st in stats.values()))}
            del own, whole
            forced_norm = norm[0].to(torch.cuda.current_device())
            adamw.global_norm = lambda tree: forced_norm  # the sharded run's norm
            try:
                result = real_update(params, opt_state, g_sharded, lr, acfg)
            finally:
                adamw.global_norm = real_norm
            rec["s"] = time.perf_counter() - t0
            forced.append(rec)
            return result

        state = step_lib.init_state(model, None, torch.Generator(device="cuda").manual_seed(0),
                                    scfg)
        step = step_lib.build_train_step(model, None, scfg)
        adamw.apply_updates = force
        try:
            state, rec = _timed_steps(step, state, batches)
        finally:
            adamw.apply_updates = real_update
        res.update(rec)
        t0 = time.perf_counter()
        res["forced"], res["end"] = forced, _compare_state(state, parts, shards, mesh)
        res["compare_s"] = [f["s"] for f in forced] + [time.perf_counter() - t0]
        print(f"replicated, {arch}: losses {res['losses']}, own norms "
              f"{[f['own_norm'] for f in forced]}, step ms {res['ms']}, peak {res['peak']}, "
              f"end {res['end']}", flush=True)
        del state, step
        gc.collect()
        torch.cuda.empty_cache()
    else:
        for k, blocks in enumerate(grads_kept):
            if rank == 0:
                dist.send(torch.tensor([res["norms"][k]], dtype=torch.float32), dst=n)
            for block in blocks:
                dist.send(block, dst=n)
        for block in kept:
            dist.send(block, dst=n)
    dist.barrier()  # the replicated rank's card memory is free
    res["arch_s"] = time.perf_counter() - t_arch
    return res


def step_phase(device) -> dict:
    """Phase 30: the sharded train step of each of ``STEP_ARCHS`` on the
    card (module docstring)."""
    del device
    shutil.rmtree(STEP_DIR, ignore_errors=True)
    preds = {}
    for arch in STEP_ARCHS:
        preds[arch] = pred = step_prediction(arch)
        print(f"phase 30 prediction, {arch} (dry-run counters, rank 0): " + json.dumps(
            {"peak_bytes": pred["peak"], "state_bytes": pred["argument_bytes"],
             "flops": pred["flops"], "collective_bytes": pred["collective"],
             "sent_by_axis": pred["by_axis"], "trace_s": pred["trace_s"]}))
    free_card()
    t0 = time.perf_counter()
    procs = step_start(free_port())
    for p in procs:
        try:
            rc = p.wait(timeout=900)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
            rc = "timeout"
        if rc != 0:
            logs = "\n".join(q.read_text()[-3000:] for q in sorted(STEP_DIR.glob("r*.log")))
            raise RuntimeError(f"chip_smoke check failed: phase 30 rank exited {rc}\n{logs}")
    wall = time.perf_counter() - t0
    runs = [pickle.load(open(STEP_DIR / f"rank{r}.pkl", "rb")) for r in range(STEP_RANKS + 1)]
    print(f"phase 30 group wall: {wall:.2f} s")
    launches: dict = {}
    for arch in STEP_ARCHS:
        for k, v in hold_step(arch, [run[arch] for run in runs], preds[arch]).items():
            launches[k] = launches.get(k, 0) + v
    return launches


def hold_step(arch: str, runs: list, pred: dict) -> dict:
    """Phase 30's checks of one architecture (module docstring); returns
    the snapshot's kernel launches."""
    rep, shard = runs[-1], runs[:-1]
    lrs, forced, r0, end = rep["lrs"], rep["forced"], shard[0], rep["end"]
    ratio = pred["peak"] / r0["peak"]
    launches: dict = {}
    for run in shard:
        for k, v in run.get("snapshot", {}).get("launches", {}).items():
            launches[k] = launches.get(k, 0) + v
    grads = [{"worst_ratio": max(
        ((p, st["sh_l2"] / st["rep_l2"], st["sh_max"] / st["rep_max"]) for p, st in
         f["grads"].items()), key=lambda t: max(t[1:])), "leaves": f["grads"]} for f in forced]
    out = {"arch": arch, "layers": STEP_LAYERS, "mesh": STEP_MESH,
           "batch": [STEP_BATCH, STEP_SEQ], "arch_s": r0["arch_s"], "tolerances": STEP_TOL,
           "f32_factor": STEP_F32_FACTOR,
           "losses": r0["losses"], "replicated_losses": rep["losses"],
           "norms": r0["norms"], "replicated_own_norms": [f["own_norm"] for f in forced],
           "replicated_norms_of_sharded_values": [f["same_values_norm"] for f in forced],
           "float64_norms": [f["f64_norm"] for f in forced],
           "norm_distance_ratio": [abs(n - f["f64_norm"])
                                   / max(abs(f["own_norm"] - f["f64_norm"]), 1e-30)
                                   for n, f in zip(r0["norms"], forced)],
           "norm_rtol_sharded_vs_replicated": [abs(n - f["own_norm"]) / f["own_norm"]
                                               for n, f in zip(r0["norms"], forced)],
           "gradients": grads, "end": end, "lrs": lrs, "compare_s": rep["compare_s"],
           "state_bytes_rank0": r0["state_bytes"], "predicted_state_bytes": pred["argument_bytes"],
           "peak_rank0": r0["peak"], "predicted_peak": pred["peak"], "peak_ratio": ratio,
           "workspace_rank0": r0["workspace"],
           "replicated_peak": rep["peak"], "flops_rank0": r0["flops"],
           "step_ms_rank0": r0["ms"], "step_ms": [run["ms"] for run in shard],
           "replicated_step_ms_less_forcing": [ms - f["s"] * 1e3
                                               for ms, f in zip(rep["ms"], forced[1:])],
           "sent_bytes_rank0_step": r0["sent"], "sent_by_axis_rank0_step": r0["by_axis"],
           "predicted_sent_by_axis": pred["by_axis"],
           "predicted_collective_bytes": pred["collective"],
           "init_s": [run["init_s"] for run in shard],
           "snapshot": [run.get("snapshot") for run in shard], "snapshot_launches": launches}
    print(f"{arch} sharded step ({card_line()}): " + json.dumps(out))

    for r, run in enumerate(shard):
        check(run["shapes_ok"], f"phase 30 {arch} rank {r}: a local leaf's shape is not its spec's")
        check(run["lrs"] == lrs, f"phase 30 {arch} rank {r}: rates {run['lrs']}")
        check(run["losses"] == r0["losses"] and run["norms"] == r0["norms"],
              f"phase 30 {arch} rank {r}: other losses or norms than rank 0")
    check(len(forced) == STEP_STEPS, f"phase 30 {arch}: {len(forced)} forced updates")
    rep_norm_rms = math.sqrt(sum((f["own_norm"] - f["f64_norm"]) ** 2 for f in forced)
                             / len(forced))  # the replicated norm's float32 distance, typical
    for k, f in enumerate(forced):
        check(f["sharded_norm"] == r0["norms"][k], f"phase 30 {arch} step {k}: the forced norm "
              f"{f['sharded_norm']} is not the sharded run's {r0['norms'][k]}")
        for name, got, want, tol in (
                ("loss", r0["losses"][k], rep["losses"][k], STEP_TOL["loss_rtol"]),
                ("norm of the same values", r0["norms"][k], f["same_values_norm"],
                 STEP_TOL["norm_rtol"])):
            check(abs(got - want) <= tol * abs(want), f"phase 30 {arch} step {k}: sharded {name} "
                  f"{got} vs replicated {want} (rtol {tol})")
        n64 = f["f64_norm"]
        check(abs(r0["norms"][k] - n64) <= STEP_F32_FACTOR * max(abs(f["own_norm"] - n64),
                                                                  rep_norm_rms),
              f"phase 30 {arch} step {k}: gradient norm, sharded {r0['norms'][k]}, replicated "
              f"{f['own_norm']}, float64 {n64}: the sharded one lies farther than "
              f"{STEP_F32_FACTOR}x the replicated one from the float64 one (or its root mean "
              f"square over the steps, {rep_norm_rms})")
        for path, st in f["grads"].items():
            check(st["sh_l2"] <= STEP_F32_FACTOR * st["rep_l2"]
                  and st["sh_max"] <= STEP_F32_FACTOR * st["rep_max"],
                  f"phase 30 {arch} step {k}: gradient {path} {st}: the sharded float32 gradient "
                  f"lies farther than {STEP_F32_FACTOR}x the replicated one from the float64 one")
    check(all(end[k]["over"] == 0 for k in end),
          f"phase 30 {arch}: the end state, sharded vs replicated {end} (params within "
          f"{STEP_TOL['param_atol']}, m and v within rtol {STEP_TOL['mv_rtol']}, every element)")
    check(r0["flops"] == pred["flops"], f"phase 30 {arch}: the card counts {r0['flops']} FLOPs "
          f"on rank 0, the meta trace {pred['flops']}")
    check(abs(ratio - 1) <= DRYRUN_PEAK_TOL, f"phase 30 {arch}: predicted peak {pred['peak']} B, "
          f"rank 0's {r0['peak']} B (ratio {ratio:.4f})")
    check(0 <= r0["workspace"] <= STEP_WORKSPACE_MAX, f"phase 30 {arch}: rank 0 keeps "
          f"{r0['workspace']} B allocated beyond its state after a step (library workspaces are "
          f"at most {STEP_WORKSPACE_MAX})")
    check(r0["by_axis"] == pred["by_axis"], f"phase 30 {arch}: rank 0 sent {r0['by_axis']} a step, "
          f"the meta trace {pred['by_axis']}")
    # only the MoE's router and expert outputs are gathered over model
    check(registry.get_config(arch).family == "moe"
          or not r0["by_axis"].get("all_gather", {}).get("model"),
          f"phase 30 {arch}: all-gathers over model {r0['by_axis']}: a split leaf was gathered")
    return launches


# ------------------------------------- the sharded serving step (phase 31) -----

SERVE_DIR = SNAPSHOT_DIR.parent / ".chip_smoke_serve_step"  # gitignored; removed at the end
SERVE_MESH = {"data": 2, "model": 2}  # 4 gloo ranks on cuda:0, as phase 30's
SERVE_RANKS = math.prod(SERVE_MESH.values())
SERVE_CAP = 8192  # the cache's capacity: 4096 positions on each model rank
# published widths, depth cut (every step gathers the parameters over data
# through the host); prompt lengths put lanes on both sides of the block
# border at 4096, and two of them cross it while decoding.  rwkv6 and hymba
# (1 layer: hymba's only layer is a global one) have no prefill: a cache
# drawn at random stands for their prompts (serve_prefill), and every model
# rank holds their whole recurrent state.  One layer and 8 steps a case (4
# for qwen3-moe, whose steps take 4-5 s) keep the phase inside the script's
# time limit and still cross the border
SERVE_CASES = {"starcoder2-3b": dict(layers=1, prompts=(1000, 4090, 4100, 7000), steps=8),
               "qwen3-moe-30b-a3b": dict(layers=1, prompts=(4093, 6000), steps=4),
               "rwkv6-1.6b": dict(layers=1, prompts=(12, 20), steps=8),
               "hymba-1.5b": dict(layers=1, prompts=(4093, 6000), steps=8)}
SERVE_CHUNK = 512  # the one-card prefill's chunk
SERVE_HELD_STEPS = (1, -1)  # steps whose K10 calls each rank holds to the plain version
# The sharded run's logits against the one-card float32 run's on the same
# inputs, both measured from a float64 evaluation of the same step (the
# step pinned to the sharded run's cache, writes included): the sharded
# run lies within this multiple of the one-card run's distance (or of its
# root mean square over the steps), in the largest element and in L2.
SERVE_F32_FACTOR = 4.0


def serve_cfg(arch: str):
    return registry.get_config(arch).scaled(n_layers=SERVE_CASES[arch]["layers"],
                                            dtype="float32")


def serve_attention(arch: str) -> str:
    """K10 (``fused``) where the model has the route, else its own plain
    attention (rwkv6 has none, hymba's windowed layers are not K10's)."""
    cls = registry.model_class(registry.get_config(arch))
    return "fused" if cls.supports_fused_attention else "xla"


def serve_prediction(arch: str) -> dict:
    """The dry run's counters for one sharded serving step of ``arch`` on
    rank 0 of ``SERVE_MESH``: a fake process group, parameters and the
    placed cache on ``meta``; K10 (which refuses ``meta``) replaced by a
    stand-in that allocates its outputs and counts no FLOPs, as
    ``FlopCounterMode`` sees none of the kernel's on the card."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore  # registers "fake"

    cfg = serve_cfg(arch)
    b = len(SERVE_CASES[arch]["prompts"])
    codec = model_layers.KVCodecConfig("blockfloat8")
    t0 = time.perf_counter()
    real = ops.kvc_attention

    def stand_in(q, kc, ks, vc, vs, index, offset=0, lse=False):
        out = torch.empty_like(q)
        return (out, torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)) if lse else out

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=SERVE_RANKS)
    ops.kvc_attention = stand_in
    try:
        mesh = init_device_mesh("cpu", tuple(SERVE_MESH.values()), mesh_dim_names=tuple(SERVE_MESH))
        model = registry.build_model(cfg, device="meta")
        serve, _, (p_abs, p_shard) = step_lib.build_serve_step(model, mesh, codec, torch.float32,
                                                               serve_attention(arch))
        params = step_lib.empty_blocks(p_abs, p_shard, mesh, "meta")
        cache_abs = model.cache_spec(b, SERVE_CAP, codec)
        cache = step_lib.empty_blocks(cache_abs, step_lib.cache_shardings(cache_abs, mesh), mesh,
                                      "meta")
        token = torch.empty((b,), dtype=torch.int32, device="meta")
        index = torch.empty((b,), dtype=torch.int32, device="meta")
        spmd.reset_sent_bytes()
        with dryrun.AllLive():
            pred = dryrun.measure(lambda: serve(params, cache, token, index), params, cache)
        pred["by_axis"] = sent_by_axis()
    finally:
        ops.kvc_attention = real
        dist.destroy_process_group()
    pred["trace_s"] = time.perf_counter() - t0
    return pred


def serve_prefill(arch: str, device) -> dict:
    """``arch``'s prompts prefilled on one card into a dense blockfloat8
    cache of ``SERVE_CAP`` positions (the model's chunked prefill, the
    engine's call; chunks of ``SERVE_CHUNK``), the parameters drawn from
    seed 0 on the card: the cache, each lane's first greedy token and its
    next position.  A model without prefill (rwkv6, hymba) takes a cache
    drawn at random in its place, as phase 28b's (codes, positive scales,
    recurrent states of scale 0.1), and random first tokens: fed token by
    token, hymba's 6000-token prompt took a large share of this phase."""
    cfg = serve_cfg(arch)
    prompts = SERVE_CASES[arch]["prompts"]
    b, longest = len(prompts), max(prompts)
    codec = model_layers.KVCodecConfig("blockfloat8")
    model = registry.build_model(cfg, device=device)
    params = step_lib.init_param_blocks(model, None, torch.Generator(device=device).manual_seed(0))
    rng = np.random.default_rng(SEED)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, size=(b, longest)).astype(np.int32)).to(device)
    lens = torch.tensor(prompts, dtype=torch.int32, device=device)
    cache = model.init_cache(b, SERVE_CAP, codec)
    last = torch.zeros((b, cfg.padded_vocab), dtype=torch.float32, device=device)
    if hasattr(model, "prefill"):
        for c0 in range(0, longest, SERVE_CHUNK):
            length = torch.clamp(lens - c0, 0, SERVE_CHUNK)
            index = torch.full((b,), c0, dtype=torch.int32, device=device)
            logits, cache = model.prefill(params, cache, toks[:, c0:c0 + SERVE_CHUNK], index,
                                          length, codec)
            ends = (lens > c0) & (lens <= c0 + SERVE_CHUNK)
            last[ends] = logits[ends]
    else:
        gen = torch.Generator(device=device).manual_seed(SEED)
        for name, leaf in cache.items():
            if leaf.dtype == torch.int8:
                leaf.copy_(torch.randint(-127, 128, leaf.shape, generator=gen, device=device,
                                         dtype=torch.int8))
            elif name.endswith("scale"):
                leaf.copy_(torch.rand(leaf.shape, generator=gen, device=device) * 1.9e-2 + 1e-3)
            else:
                leaf.copy_(torch.randn(leaf.shape, generator=gen, device=device) * 0.1)
        last = torch.randn(last.shape, generator=gen, device=device)
    return {"cache": {k: v.cpu() for k, v in cache.items()},
            "token": last.argmax(-1).to(torch.int32).cpu(), "index": lens.cpu()}


def serve_start(port: int) -> list:
    """Phase 31's group: ``SERVE_RANKS`` ranks, each this script with
    ``--serve-rank``, all on cuda:0."""
    procs = []
    for rank in range(SERVE_RANKS):
        log = open(SERVE_DIR / f"r{rank}.log", "w")
        procs.append(subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--serve-rank", str(rank),
             str(SERVE_RANKS), str(port), str(SERVE_DIR)], stdout=log, stderr=subprocess.STDOUT))
    CHILD_PROCS.extend(procs)
    return procs


def serve_worker(argv: list[str]) -> int:
    """One rank of :func:`serve_start`'s group: each of ``SERVE_CASES`` in
    turn (:func:`_serve_arch`)."""
    rank, world, port, out = int(argv[0]), int(argv[1]), argv[2], Path(argv[3])
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world,
                            rank=rank)
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        mesh = make_mesh(tuple(SERVE_MESH.values()), tuple(SERVE_MESH), "cuda")
        res = {arch: _serve_arch(arch, rank, mesh) for arch in SERVE_CASES}
        with open(out / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(res, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


class Routes:
    """Records every MoE routing's chosen experts and kept assignments
    (host copies) while active."""

    def __enter__(self):
        self._orig, self.calls = moe_lib.route, []

        def recorded(p, c, xf):
            r = self._orig(p, c, xf)
            self.calls.append((r.top_e.cpu(), r.valid.cpu()))
            return r

        moe_lib.route = recorded
        return self

    def __exit__(self, *exc):
        moe_lib.route = self._orig


def k10_exact_block(q, kc, ks, vc, vs, index, offset: int):
    """K10's block function in float64 (row r at position ``offset + r``),
    with :func:`k10_exact`'s terms: (out, lse, L, V, S)."""
    pos = offset + torch.arange(kc.shape[1], device=q.device)
    idx = torch.as_tensor(index, dtype=torch.int32, device=q.device).reshape(-1)
    live = pos[None, :] <= idx[:, None]  # (B, S)
    n_rep = q.shape[1] // kc.shape[2]
    k = torch.repeat_interleave(kc.double() * ks.double()[..., None], n_rep, dim=2)
    logits = torch.einsum("bhd,bshd->bhs", q.double(), k) * q.shape[-1] ** -0.5
    lse = torch.logsumexp(logits.masked_fill(~live[:, None, :], -math.inf), dim=-1)
    local = (idx - offset).clamp(-1, kc.shape[1] - 1)
    out, lmax, vmax, slen = k10_exact(q, kc, ks, vc, vs, local)
    return out, lse, lmax, vmax, slen


class K10Blocks:
    """While active, holds each K10 call on a cache block (``offset`` and
    ``lse``) against its plain version on the same inputs and against the
    same function in float64 (:func:`k10_exact_block`), with
    :class:`K10Held`'s bar: ``out`` within half an ulp of its dtype plus
    2^-24 * V * (L + S) of float64's, ``lse`` within 2^-24 * (|lse| +
    (log2(D) + 3) L + S) (a logit's float32 sum of D products is log2(D)
    roundings deep, and two multiplies follow), -inf at exactly the lanes
    with no position in the block; within twice those of the plain version
    (each float32 program within one).
    The plain version's distance from float64 is recorded beside it.  The
    comparisons launch no K10."""

    def __init__(self):
        self.calls, self.err, self.lse_err, self.plain_err, self.share = 0, 0.0, 0.0, 0.0, 0.0

    def __enter__(self):
        self._orig = ops.kvc_attention

        def held(q, kc, ks, vc, vs, index, offset=0, lse=False):
            got = self._orig(q, kc, ks, vc, vs, index, offset, lse)
            if not lse:
                return got
            out, l = got
            ex, ex_lse, lmax, vmax, slen = k10_exact_block(q, kc, ks, vc, vs, index, offset)
            half = torch.finfo(out.dtype).eps * torch.ldexp(torch.ones_like(ex),
                                                            torch.frexp(ex.abs())[1] - 2)
            bar = 2.0 ** -24 * vmax * (lmax + slen)
            excess = float(((out.double() - ex).abs() - half).max())
            check(excess <= bar, f"K10 block at offset {offset} is {excess} beyond its output "
                  f"rounding from float64 (bar {bar}: L {lmax}, V {vmax}, S {slen})")
            check(torch.equal(torch.isinf(l), torch.isinf(ex_lse)),
                  f"K10 block at offset {offset}: lse -inf at other lanes than float64's")
            fin = torch.isfinite(ex_lse)
            # a logit sums D products (log2 D roundings deep) and takes two
            # more multiplies; the sum of exponents adds S roundings
            depth = math.log2(q.shape[-1]) + 3
            lbar = 2.0 ** -24 * (ex_lse[fin].abs() + depth * lmax + slen)
            if bool(fin.any()):
                dl = (l[fin].double() - ex_lse[fin]).abs()
                check(bool((dl <= lbar).all()), f"K10 block at offset {offset}: lse "
                      f"{float(dl.max())} from float64 (bar {float(lbar.max())})")
                self.lse_err = max(self.lse_err, float(dl.max()))
            plain, plain_lse = kref.kvc_decode_attention_ref(q, kc, ks, vc, vs, index, offset,
                                                             True)
            check(float(((out.double() - plain.double()).abs() - half).max()) <= 2 * bar,
                  f"K10 block at offset {offset}: beyond twice the bar {bar} from the plain version")
            check(torch.equal(torch.isinf(l), torch.isinf(plain_lse)) and bool(
                ((l - plain_lse)[fin].double().abs() <= 2 * lbar).all() if bool(fin.any())
                else True), f"K10 block at offset {offset}: lse apart from the plain version's")
            self.plain_err = max(self.plain_err, float((plain.double() - ex).abs().max()))
            self.err = max(self.err, float((out.double() - ex).abs().max()))
            self.share = max(self.share, max(excess, 0.0) / bar if bar else 0.0)
            self.calls += 1
            return got

        ops.kvc_attention = held
        return self

    def __exit__(self, *exc):
        ops.kvc_attention = self._orig


def _gather_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """Every ``data`` rank's rows of ``x`` (this rank's, dim 0) on the host,
    in rank order."""
    group = mesh.get_group("data")
    parts = [torch.empty_like(x.cpu()) for _ in range(SERVE_MESH["data"])]
    dist.all_gather(parts, x.detach().cpu().contiguous(), group=group)
    return torch.cat(parts)


def _serve_arch(arch: str, rank: int, mesh) -> dict:
    """One architecture of phase 31 on this rank: the prefilled cache
    placed, then ``steps`` greedy decode steps of the sharded serving step
    (``(B,)`` per-slot index, K10 on this rank's block in every layer); the
    first step under ``FlopCounterMode`` with its peak counted, the bytes
    sent by kind and axis, every step's host ms."""
    cfg, case = serve_cfg(arch), SERVE_CASES[arch]
    codec = model_layers.KVCodecConfig("blockfloat8")
    device = torch.device("cuda", 0)
    t_arch = time.perf_counter()
    model = registry.build_model(cfg, device=device)
    serve, place_cache, (p_abs, p_shard) = step_lib.build_serve_step(
        model, mesh, codec, torch.float32, serve_attention(arch))
    params = step_lib.init_param_blocks(model, mesh, torch.Generator(device=device).manual_seed(0))
    pre = torch.load(SERVE_DIR / f"{arch}.pt")
    whole = sum(v.numel() * v.element_size() for v in pre["cache"].values())
    cache = place_cache({k: v.to(device) for k, v in pre["cache"].items()})
    locals_ = [sharding.local(x) for x in tree_util.tree_flatten(cache)[0]]
    res = {"cache_bytes": sum(t.numel() * t.element_size() for t in locals_), "whole_bytes": whole,
           "specs": {k: sharding.spec_of(v) if sharding.is_dtensor(v) else ()
                     for k, v in cache.items()}, "data_rank": mesh.get_coordinate()[0]}
    recurrent = [k for k, spec in res["specs"].items() if len(spec) < 3]  # no sequence split
    args = sum(dryrun.alloc_bytes(t.numel() * t.element_size()) for t in locals_ + [
        sharding.local(x) for x in tree_util.tree_flatten(params)[0]])
    del locals_, pre["cache"]
    token, index = pre["token"].to(device), pre["index"].to(device)
    (torch.ones(8, 8, device=device) @ torch.ones(8, 8, device=device)).sum().item()  # cuBLAS
    steps = case["steps"]
    held_steps = {s % steps for s in SERVE_HELD_STEPS}
    tokens, logits, ms, routes, states = [token.cpu()], [], [], [], []
    k10.launches["kvc_decode_attention"] = 0
    held = K10Blocks()
    for t in range(steps):
        ctx = contextlib.ExitStack()
        rec = ctx.enter_context(Routes())
        if t == 0:
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            spmd.reset_sent_bytes()
            counter = ctx.enter_context(FlopCounterMode(display=False))
        elif t in held_steps:
            ctx.enter_context(held)
        with ctx:
            t0 = time.perf_counter()
            lg, cache = serve(params, cache, token, index)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        if t == 0:
            res["flops"] = float(counter.get_total_flops())
            res["peak"] = torch.cuda.max_memory_allocated() - (before - args)
            res["by_axis"] = sent_by_axis()
        rows = _gather_rows(sharding.local(lg), mesh)
        logits.append(rows)
        routes.append(rec.calls)
        states.append({k: sharding.local(cache[k]).cpu() for k in recurrent})
        token = rows.argmax(-1).to(torch.int32).to(device)
        index = index + 1
        tokens.append(token.cpu())
    res.update(launches=k10.launches["kvc_decode_attention"], ms=ms, tokens=tokens,
               logits=logits if rank == 0 else None, routes=routes, k10_calls=held.calls,
               k10_err=held.err, k10_lse_err=held.lse_err, k10_plain_err=held.plain_err,
               k10_share=held.share, states=states,
               blocks={k: sharding.local(v).cpu() for k, v in cache.items()})
    print(f"rank {rank}, {arch}: step ms {[round(x, 1) for x in ms]}, peak {res['peak']}, "
          f"flops {res['flops']}, K10 launches {res['launches']}", flush=True)
    del params, cache, serve
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()
    res["arch_s"] = time.perf_counter() - t_arch
    return res


def _whole_cache(blocks: list, specs: dict) -> dict:
    """The whole cache from each rank's blocks (rank order over
    ``SERVE_MESH``; ``(None, "data", "model")`` splits lanes and
    positions, ``(None, "data")`` lanes, the first ``model`` rank's taken)."""
    out = {}
    for name, spec in specs.items():
        check(tuple(spec) in ((None, "data", "model"), (None, "data")),
              f"phase 31: cache {name} placed {spec}")
        rows = []
        for d in range(SERVE_MESH["data"]):
            parts = [blocks[d * SERVE_MESH["model"] + m][name]
                     for m in range(SERVE_MESH["model"])]
            rows.append(torch.cat(parts, dim=2) if len(spec) > 2 else parts[0])
        out[name] = torch.cat(rows, dim=1)
    return out


@contextlib.contextmanager
def _no_writes():
    """The model's cache writes made no-ops while active (a pinned step
    attends to the sharded run's cache, the rows it wrote included)."""
    real = model_layers.cache_write
    model_layers.cache_write = lambda cache, *args, **kwargs: cache
    try:
        yield
    finally:
        model_layers.cache_write = real


def _distances(a: torch.Tensor, b: torch.Tensor) -> tuple[float, float]:
    """(largest element, L2) of ``a - b`` in float64."""
    d = a.double() - b.double()
    return float(d.abs().max()), float(d.norm())


def hold_serve(arch: str, runs: list, pre: dict, pred: dict, device) -> dict:
    """Phase 31's checks of ``arch`` (module docstring), replaying each step
    on one card in float32 (K10 where the model has the route) and float64
    from the sharded run's cache; a recurrent state starts from the
    prefill's and each replay advances its own."""
    cfg, case = serve_cfg(arch), SERVE_CASES[arch]
    steps, layers = case["steps"], case["layers"]
    codec = model_layers.KVCodecConfig("blockfloat8")
    attention = serve_attention(arch)
    k10_layers = layers if attention == "fused" else 0
    r0 = runs[0]
    specs = r0["specs"]
    share = {k: math.prod(SERVE_MESH[a] for a in spec if a) for k, spec in specs.items()}
    want_bytes = sum(v.numel() * v.element_size() // share[k] for k, v in pre["cache"].items())
    for r, run in enumerate(runs):
        check(all(torch.equal(a, b) for a, b in zip(run["tokens"], r0["tokens"])),
              f"phase 31 {arch}: rank {r}'s tokens differ from rank 0's")
        check(run["launches"] == k10_layers * steps,
              f"phase 31 {arch}: rank {r} launched K10 {run['launches']} times, not "
              f"{k10_layers} layers x {steps} steps")
        check(run["cache_bytes"] == want_bytes,
              f"phase 31 {arch}: rank {r} holds {run['cache_bytes']} cache bytes, its blocks of "
              f"{run['whole_bytes']} placed {specs} are {want_bytes}")
        check(run["k10_calls"] == k10_layers * len(SERVE_HELD_STEPS),
              f"phase 31 {arch}: rank {r} held {run['k10_calls']} K10 block calls")
    ratio = pred["peak"] / r0["peak"]
    check(abs(ratio - 1) <= DRYRUN_PEAK_TOL, f"phase 31 {arch}: predicted peak {pred['peak']} B, "
          f"rank 0's {r0['peak']} B (ratio {ratio:.4f})")
    check(r0["flops"] == pred["flops"], f"phase 31 {arch}: the card counts {r0['flops']} FLOPs "
          f"on rank 0, the meta trace {pred['flops']}")
    check(r0["by_axis"] == pred["by_axis"], f"phase 31 {arch}: rank 0 sent {r0['by_axis']} a "
          f"step, the meta trace {pred['by_axis']}")
    final = _whole_cache([run["blocks"] for run in runs], specs)
    recurrent = [k for k, spec in specs.items() if len(spec) < 3]
    model = registry.build_model(cfg, device=device)
    params = step_lib.init_param_blocks(model, None, torch.Generator(device=device).manual_seed(0))
    p64 = tree_util.tree_unflatten(tree_util.tree_structure(params), [
        x.double() for x in tree_util.tree_flatten(params)[0]])
    # each step reads positions up to its index, which the sharded run's
    # final cache holds as they were at that step (later rows lie past it);
    # a recurrent state is overwritten each step, so both replays start
    # from the prefill's and advance their own
    cache = {k: v.to(device) for k, v in final.items()}
    cache64 = dict(cache)
    for k in recurrent:
        cache[k] = pre["cache"][k].to(device).clone()
        cache64[k] = pre["cache"][k].to(device, torch.float64)
    index = pre["index"].to(device)
    lanes = len(case["prompts"]) // SERVE_MESH["data"]
    d1, ds, one_routes = [], [], []
    held_states = []  # (step, leaf, rank, one-card distance, sharded distance) from float64
    for t in range(steps):
        tok = r0["tokens"][t].to(device)
        with _no_writes(), Routes() as rec:
            l1, _ = model.decode_step(params, cache, tok, index, codec, attention=attention)
        one_routes.append(rec.calls)
        with _no_writes(), float64_model(model):
            l64, _ = model.decode_step(p64, cache64, tok, index, codec, attention="xla")
        ls = r0["logits"][t].to(device)
        check(torch.equal(l1.argmax(-1).to(torch.int32).cpu(), r0["tokens"][t + 1]),
              f"phase 31 {arch} step {t}: the one-card tokens {l1.argmax(-1).tolist()}, the "
              f"sharded run's {r0['tokens'][t + 1].tolist()}")
        d1.append(_distances(l1, l64))
        ds.append(_distances(ls, l64))
        # every rank's whole state (its data rank's lanes) after this step
        for k in recurrent:
            for r, run in enumerate(runs):
                rows = slice(run["data_rank"] * lanes, (run["data_rank"] + 1) * lanes)
                held_states.append((t, k, r, _distances(cache[k][:, rows], cache64[k][:, rows]),
                                    _distances(run["states"][t][k].to(device),
                                               cache64[k][:, rows])))
        index = index + 1
    for t, (a, b) in enumerate(zip(one_routes, r0["routes"])):
        check(len(a) == len(b) and all(torch.equal(x[0], y[0]) and torch.equal(x[1], y[1])
                                       for x, y in zip(a, b)),
              f"phase 31 {arch} step {t}: the MoE routing (top_e, drop mask) differs from the "
              "one-card run's")
    rms = [math.sqrt(sum(d[i] ** 2 for d in d1) / len(d1)) for i in (0, 1)]
    for t, (a, b) in enumerate(zip(d1, ds)):
        for i, what in enumerate(("largest element", "L2")):
            check(b[i] <= SERVE_F32_FACTOR * max(a[i], rms[i]),
                  f"phase 31 {arch} step {t}: the sharded logits lie {b[i]} ({what}) from float64, "
                  f"the one-card float32 run's {a[i]} (RMS over the steps {rms[i]}), more than "
                  f"{SERVE_F32_FACTOR}x")
    for k in recurrent:  # each rank's recurrent state, held as the logits are
        mine = [x for x in held_states if x[1] == k]
        srms = [math.sqrt(sum(x[3][i] ** 2 for x in mine) / len(mine)) for i in (0, 1)]
        for t, _, r, a, b in mine:
            for i, what in enumerate(("largest element", "L2")):
                check(b[i] <= SERVE_F32_FACTOR * max(a[i], srms[i]),
                      f"phase 31 {arch} step {t}: rank {r}'s state {k} lies {b[i]} ({what}) from "
                      f"float64, the one-card float32 run's {a[i]} (RMS {srms[i]}), more than "
                      f"{SERVE_F32_FACTOR}x")
    row = {"peak_pred": pred["peak"], "peak_rank0": r0["peak"], "ratio": ratio,
           "flops": r0["flops"], "sent_by_axis": r0["by_axis"], "attention": attention,
           "cache_bytes_rank": r0["cache_bytes"], "cache_bytes_whole": r0["whole_bytes"],
           "k10_launches_rank": [run["launches"] for run in runs],
           "k10_block_f64_max_abs": max(run["k10_err"] for run in runs),
           "k10_plain_block_f64_max_abs": max(run["k10_plain_err"] for run in runs),
           "k10_block_lse_f64_max_abs": max(run["k10_lse_err"] for run in runs),
           "k10_largest_share_of_bar": max(run["k10_share"] for run in runs),
           "logits_f64_one_card": d1, "logits_f64_sharded": ds,
           "state_f64_one_card_max": max((x[3][0] for x in held_states), default=None),
           "state_f64_sharded_max": max((x[4][0] for x in held_states), default=None),
           "dropped": sum(int((~v).sum()) for calls in r0["routes"] for _, v in calls),
           "step_ms_rank0": r0["ms"], "arch_s": [run["arch_s"] for run in runs]}
    print(f"phase 31, {arch} ({card_line()}): " + json.dumps(row))
    del model, params, p64, cache, cache64
    free_card()
    return {"kvc_decode_attention": sum(run["launches"] for run in runs)}


def k10_block_times(device) -> dict:
    """K10 at phase 31's block (starcoder2-3b's widths: 2 lanes of a data
    rank, 24 q over 2 KV heads, D 128, float32 q, 4096 positions a block,
    offset 4096, lanes at 4099 and 6999): the block entry with its
    log-sum-exp, the whole-cache call over both blocks, the plain block
    version; CUDA-graph replays, the bound from the positions read."""
    b, s, h, hkv, d = 2, SERVE_CAP, 24, 2, 128
    g = torch.Generator(device=device).manual_seed(SEED)
    q = torch.randn((b, h, d), generator=g, device=device)
    kc, vc = (torch.randint(-127, 128, (b, s, hkv, d), generator=g, device=device,
                            dtype=torch.int8) for _ in range(2))
    ks, vs = (torch.rand((b, s, hkv), generator=g, device=device) * 0.05 + 1e-3 for _ in range(2))
    ix = torch.tensor([4099, 6999], dtype=torch.int32, device=device)
    half = s // 2
    blk = [t[:, half:].contiguous() for t in (kc, ks, vc, vs)]
    live = sum(int(i) + 1 - half for i in ix)
    nbytes = live * hkv * (2 * d + 8) + 2 * 4 * b * h * d + 4 * b * h + 4 * b
    row = {"block_ms": graph_ms(lambda: k10.kvc_decode_attention(q, *blk, ix, half, True)),
           "whole_ms": graph_ms(lambda: k10.kvc_decode_attention(q, kc, ks, vc, vs, ix)),
           "plain_block_ms": graph_ms(lambda: kref.kvc_decode_attention_ref(q, *blk, ix, half,
                                                                            True),
                                      iters=PLAIN_ITERS),
           "positions": live, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
           "splits": k10.split_plan(b, hkv, half, torch.cuda.get_device_properties(
               device).multi_processor_count)[0]}
    row["share_of_bound"] = row["bound_ms"] / row["block_ms"]
    print(f"K10 at phase 31's block ({card_line()}): " + json.dumps(row))
    return row


def serve_phase(device) -> dict:
    """Phase 31: the sharded serving step of each of ``SERVE_CASES`` on the
    card (module docstring)."""
    shutil.rmtree(SERVE_DIR, ignore_errors=True)
    SERVE_DIR.mkdir(parents=True)
    preds, pres = {}, {}
    for arch in SERVE_CASES:
        preds[arch] = pred = serve_prediction(arch)
        print(f"phase 31 prediction, {arch} (dry-run counters, rank 0): " + json.dumps(
            {"peak_bytes": pred["peak"], "argument_bytes": pred["argument_bytes"],
             "flops": pred["flops"], "sent_by_axis": pred["by_axis"],
             "trace_s": pred["trace_s"]}))
        t0 = time.perf_counter()
        pres[arch] = serve_prefill(arch, device)
        torch.save(pres[arch], SERVE_DIR / f"{arch}.pt")
        print(f"phase 31 {arch}: one-card prefill of {SERVE_CASES[arch]['prompts']} tokens in "
              f"{time.perf_counter() - t0:.2f} s")
    free_card()
    t0 = time.perf_counter()
    procs = serve_start(free_port())
    for p in procs:
        try:
            rc = p.wait(timeout=600)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
            rc = "timeout"
        if rc != 0:
            logs = "\n".join(q.read_text()[-3000:] for q in sorted(SERVE_DIR.glob("r*.log")))
            raise RuntimeError(f"chip_smoke check failed: phase 31 rank exited {rc}\n{logs}")
    print(f"phase 31 group wall: {time.perf_counter() - t0:.2f} s")
    runs = [pickle.load(open(SERVE_DIR / f"rank{r}.pkl", "rb")) for r in range(SERVE_RANKS)]
    launches: dict = {}
    for arch in SERVE_CASES:
        for k, v in hold_serve(arch, [run[arch] for run in runs], pres[arch], preds[arch],
                               device).items():
            launches[k] = launches.get(k, 0) + v
    k10_block_times(device)
    return launches


def run(device) -> dict:
    t0 = time.perf_counter()
    logs = _build.build(verbose=True)
    print(f"kernel build: {time.perf_counter() - t0:.2f} s ({len(logs)} sources compiled)")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    resources = ptxas_resources(logs)

    t0 = time.perf_counter()
    fields = cosmo.nyx_fields(n=N, seed=SEED)
    print(f"nyx_fields(n={N}, seed={SEED}): {time.perf_counter() - t0:.2f} s")
    ebs = {k: REL_EB * float(v.max() - v.min()) for k, v in fields.items()}
    base = torch.from_numpy(fields["baryon_density"]).to(device)
    vx = torch.from_numpy(fields["vx"]).to(device)
    ragged = vx[: N - 56, : N - 126, : N - 6].contiguous()
    inputs = {f"{N}^3 baryon_density": (base, ebs["baryon_density"]),
              "ragged vx": (ragged, ebs["vx"])}
    worst = kernels_vs_plain(inputs, device)

    hacc = cosmo.hacc_particles(grid=HACC_GRID)
    small = cosmo.nyx_fields(n=SMALL_N, seed=SEED)
    sharded_data(fields, hacc, small)
    cpu_pair = sharded_start("cpu")  # runs beside phases 2-15 on the host's free cores
    print(f"sharded CPU pair started ({SHARDED_POD} gloo ranks; state in {SHARDED_DIR.name}/)")
    shutil.rmtree(DRILL_DIR, ignore_errors=True)
    cpu_drill = drill_start("cpu")  # phase 26's CPU group, beside phases 2-15 like the pair
    print(f"drill CPU group started ({DRILL_RANKS} gloo ranks; state in {DRILL_DIR.name}/)")

    launches = main_path(fields, device)
    agrees_with_cpu(small, device)
    core_backend(fields["baryon_density"], hacc.fields["vx"], device)

    worst.update(zfp_kernels_vs_plain({f"{N}^3 baryon_density": base, "ragged vx": ragged},
                                      device))
    launches.update(zfp_main_path(fields, device))
    zfp_nyx_512(base)
    zfp_agrees_with_cpu(cosmo.nyx_fields(n=SMALL_N, seed=SEED), device)
    zfp_hacc(hacc, device)

    names = list(fields)
    xb = torch.stack([torch.from_numpy(fields[k]).to(device) for k in names[:K_ROWS]])
    eb_rows = sz_core.internal_bound(xb.abs().amax(dim=(1, 2, 3)),
                                     torch.tensor([ebs[k] for k in names[:K_ROWS]], device=device))
    small3 = torch.stack([torch.from_numpy(fields[k][:16, :128, :256].copy()).to(device)
                          for k in ("vx", "vy", "vz")])
    eb3 = sz_core.internal_bound(small3.abs().amax(dim=(1, 2, 3)), torch.tensor(
        [REL_EB * 2e8, 1e-3 * 2e8, 1e-2 * 2e8], device=device))
    xr, ebr = sz_cases.rows()
    hard = sz_cases.cases(SEED)
    edge = torch.stack([torch.zeros(16, 64, 128), hard["full_width"][0].repeat(2, 1, 1), xr[0]])
    worst.update(batched_vs_plain({f"{K_ROWS} x {N}^3 Nyx": (xb, eb_rows),
                                   "3 x (16, 128, 256) vx/vy/vz": (small3, eb3),
                                   "sz_cases.rows (ratios > 4x apart)": (xr.to(device),
                                                                         ebr.to(device)),
                                   "rows at width 0, 32 and mixed": (edge.to(device), torch.tensor(
                                       [1e-2, 1.0, 0.5], device=device))}))
    try:
        launches.update(snapshot_path(fields, hacc, small, device))
        snapshot_agrees_with_cpu(fields, hacc, device)
    finally:
        shutil.rmtree(SNAPSHOT_DIR, ignore_errors=True)

    foresight = foresight_and_insitu(fields, small, hacc, base, ebs["baryon_density"], cpu_pair,
                                     device)

    torch.backends.cuda.matmul.allow_tf32 = False  # the comparison phases run in full f32
    torch.backends.cudnn.allow_tf32 = False
    print("TF32 off from here: torch.backends.cuda.matmul.allow_tf32 = "
          f"{torch.backends.cuda.matmul.allow_tf32}, torch.backends.cudnn.allow_tf32 = "
          f"{torch.backends.cudnn.allow_tf32}")
    worst["kvc_decode_attention"] = k10_vs_plain(device)
    serving = serving_full_width(device)
    launches["kvc_decode_attention"] = serving["k10_launches"]
    serving_card_vs_cpu(device)

    for label, fn in (("22 router at full width", lambda: router_full_width(
                          device, serving["tokens"])),
                      ("23 training at full width", lambda: train_full_width(device)),
                      ("24 training loop, checkpoints, the hook and a gloo pair",
                       lambda: train_loop_phase(device)),
                      ("25 supervised drill, one rank", lambda: supervised_phase(device)),
                      ("26 shrink and grow-back drill, 8 gloo ranks",
                       lambda: drill_phase(cpu_drill)),
                      ("27 qwen3-moe-30b-a3b at its published widths", lambda: moe_full_width(
                          device)),
                      ("28 rwkv6, hymba, whisper and the new families card vs CPU",
                       lambda: other_families(device)),
                      ("29 the dry run against the card", lambda: dryrun_vs_card(device)),
                      ("30 the sharded train step on model blocks", lambda: step_phase(device)),
                      ("31 the sharded serving step, K10 on cache blocks",
                       lambda: serve_phase(device)),
                      ("32 hymba-1.5b served past its window", lambda: hymba_served_past_window(
                          device))):
        t0 = time.perf_counter()
        for k, v in fn().items():
            launches[k] = launches.get(k, 0) + v
        print(f"phase {label}: {time.perf_counter() - t0:.2f} s")

    stages = stage_times(base, ebs["baryon_density"])
    print(f"stages at {N}^3 baryon_density (median ms; peak MiB): " + json.dumps(stages))
    print("K6/K7 registers and spill bytes: " + json.dumps(
        {k: v for k, v in resources.items() if k.startswith("zfp_fused")}))
    stages = zfp_stage_times(base)
    print(f"ZFP stages at {N}^3 baryon_density, rate {ZFP_RATE} (median ms; peak MiB): "
          + json.dumps(stages))
    stages = zfp_stage_times(torch.cat([base, vx], dim=2))
    print(f"ZFP stages at a Nyx box, {N} x {N} x {2 * N} baryon_density | vx, rate {ZFP_RATE} "
          "(median ms; peak MiB): " + json.dumps(stages))
    times = kernel_times(base, ebs["baryon_density"])
    times.update(batched_kernel_times(xb, eb_rows))
    times["kvc_decode_attention"], _ = k10_times(device, serving, resources)
    k1 = times["lorenzo3d_quantize"]
    print("K1 (graph replay ms, bound ms, share of bound, registers and spill bytes): "
          + json.dumps({"ms": k1["ms"], "bound_ms": k1["bound_ms"],
                        "share_of_bound": k1["bound_ms"] / k1["ms"],
                        **resources.get("lorenzo3d_quantize_kernel", {})}))
    print("kernel bounds (ms: bytes, operations, per pipe) and event-timed direct calls (ms): "
          + json.dumps({name: [t["bytes_ms"], t["ops_ms"], t.get("pipes_ms"), t["call_ms"]]
                        for name, t in times.items()}))
    rows = []
    for name, (kid, source, replaces) in KERNELS.items():
        t = times[name]
        rows.append({"name": f"{kid} {name}", "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[name] + foresight.get(name, 0),
                     "max_abs_err": worst[name], "ms": t["ms"], "plain_ms": t["plain_ms"],
                     "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                     "library_ms": t.get("library_ms")})
    return {"kernels": rows}


def main() -> int:
    if sys.argv[1:2] == ["--insitu-rank"]:  # one rank of a two-process group (insitu_start)
        return insitu_worker(sys.argv[2:])
    if sys.argv[1:2] == ["--sharded-rank"]:  # one rank of a sharded pair (sharded_start)
        return sharded_worker(sys.argv[2:])
    if sys.argv[1:2] == ["--train-rank"]:  # one rank of the training pair (train_start)
        return train_worker(sys.argv[2:])
    if sys.argv[1:2] == ["--drill-rank"]:  # one rank of the drill group (drill_start)
        return drill_worker(sys.argv[2:])
    if sys.argv[1:2] == ["--step-rank"]:  # one rank of phase 30's group (step_start)
        return step_worker(sys.argv[2:])
    if sys.argv[1:2] == ["--serve-rank"]:  # one rank of phase 31's group (serve_start)
        return serve_worker(sys.argv[2:])
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA card",
              file=sys.stderr)
        return 1
    print(card_line())
    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    try:
        report = run(torch.device("cuda"))
    finally:
        for p in CHILD_PROCS:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(SHARDED_DIR, ignore_errors=True)
        shutil.rmtree(TRAIN_DIR, ignore_errors=True)
        shutil.rmtree(DRILL_DIR, ignore_errors=True)
        shutil.rmtree(DRYRUN_DIR, ignore_errors=True)
        shutil.rmtree(STEP_DIR, ignore_errors=True)
        shutil.rmtree(SERVE_DIR, ignore_errors=True)
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps(report))
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
