#!/usr/bin/env python3
"""Chip smoke for paddle_tpu_torch on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each failing the script (non-zero exit) when it fails:

1. The card's name and power limit (nvidia-smi), the torch/CUDA
   versions, and the build of every hand-written kernel from the
   sources in this checkout (one nvcc per source, all at once), with
   nvcc's -Xptxas -v register, shared-memory and spill summary; the
   D = 64 instantiations of the three bf16 attention kernels (the
   forward at both q tiles) and every bf16 instantiation of the int8
   dequant-matmul must not spill.
2. Kernel checks, each kernel against its plain PyTorch version on the
   card at the shapes of its main path, with kernel, plain and library
   times from CUDA events, the bound and the error (one JSON line per
   shape):
   - the fused int8 dequant-matmul, bf16 x, at the GPT and the Llama
     serving shapes (M = 8 slots at decode, 128 and 512 at prefill, and
     at Llama's shapes 40, the spec verify pass of 8 slots x (gamma 4 +
     1), 256, the paged prefill chunk, and 1024, the dense path's largest
     prefill bucket;
     K, N of GPT's qkv, attention-out, MLP-up, MLP-down and head matmuls
     and of Llama's q/o, k/v, gate/up, down and head), the same bits
     twice at each, then one row for each family's decode tick (GPT's 97
     calls, Llama's 155, at M = 8 summed); then the f64 bound check: at
     every leaf shape and M = 8, 16, 128 and 512 (and 40, 256 and 1024 at
     Llama's),
     on `_plan`'s plan and, where
     it splits K, unsplit too, every element of the kernel's bf16 output
     within ulp_bf16(y64) + K 2^-24 ((|x| @ |w|) scale) of the f64 value
     y64 = (x @ w) scale of the same bf16 x (the plain version's distance
     printed beside it);
   - the flash-attention forward and its dq and dk/dv backward kernels,
     bf16, causal, at the GPT train step's [8, 1024, 16, 64] (q, k, v
     strided views of one qkv tensor, as the GPT block makes them), a
     ragged S 1000 with kv_len 900, head dim 128, and the Llama train
     step's [4, 2048, 32, 64]; every kernel runs on tensor cores on
     bf16; the forward and the backward pair run twice must give the
     same bits; the forward's time is set beside SDPA's forward and the
     pair's beside SDPA's whole backward (vs_library); at the Llama
     shape, the kernels' and the plain versions' largest errors against
     an f64 attention from the same inputs, forward and backward (a
     measurement line);
   - the one-pass cross entropy, bf16, at [8192, 32768] (the GPT train
     step's logits), [8192, 50304] and [8192, 50257] (rows off a 16-byte
     boundary), and f32 at [2048, 128256] (a row over a cluster of 3
     blocks), each with the plan it launches under;
   - the two-pass cross entropy (forward saving the lse, backward from
     it), bf16, at [8192, 32000] (the Llama train step's logits) and
     [8192, 50257] (rows off a 16-byte boundary), the backward at
     g = 1/T (the mean loss) and g = 1;
   - the AdamW update, f32, at each of the 11 leaf shapes of the
     TinyLlama-width tree alone, then over all 11 in one launch (one
     step's update), with torch._fused_adamw_ as the yardstick;
   - the threefry bits kernel (the serving sampler's draw, the slot
     keys' fold_ins included) at [8, 32768] and [8, 32000] (8 slots,
     the GPT and Llama vocabularies), every word equal to its plain
     int64 version, twice; each serving main path must launch it
     exactly once a sampled tick and a sampled prefill pass, and the
     phases with sampled requests (5, 5b, 5c, 5d) must each launch it.
3. GPT training at the full width of the repo's headline configuration
   (bench.py's `tpu` rung: vocab 32768, hidden 1024, 24 layers, 16
   heads, max_seq_len 1024, batch 8 x 1024 tokens, remat "dots", bf16
   activations, f32 parameters, random weights from seed 0), with the
   registry's "ce" winner forced to "pallas_fused" (the one-pass CE) as
   the reference's tools/ablate_step.py forces its own.
3b. The GPT step's selection surface at the same widths and 2 of its
   24 layers (RACE_LAYERS), the port's
   counterpart of the rung's variant race (bench.py:270-320) with the
   attention impl fixed to "pallas" (on CUDA "jax_flash" and "splash"
   run the same kernels): from one starting state, 2 warm-up and 10
   timed steps under remat "dots", "full", "dots_flash", "offload_dots"
   and "all_but_mlp" at batch 8, "all_but_mlp" at 12, no remat at 4 and
   "dots" at 16, the CE and the update on their default routes; each
   variant's step ms p50/p90, tokens/s, MFU, peak memory, pinned host
   bytes and a one-step profile, its kernel launches asserted (the flash
   forward L a step under dots_flash, all_but_mlp and no remat, 2L
   otherwise; dq and dk/dv L) and its first loss at batch 8 held to
   "dots"'s (1e-6 relative); a variant out of device memory is printed
   as OOM; then the fastest. Then one step at 4 layers under each
   route: PADDLE_TPU_ATTN_IMPL=xla and PADDLE_TPU_DISABLE_PALLAS_ATTN=1
   (no flash launch, loss within 2e-3 of the kernel step's),
   PADDLE_TPU_DISABLE_PALLAS_BWD=1 (no dq or dk/dv launch),
   PADDLE_TPU_DISABLE_PALLAS=1 (no launch at all, the CE on "jax"),
   PADDLE_TPU_ATTN_IMPL=splash and jax_flash (the kernels), each set for
   its own step, and a last default step. Then the forward's two q
   tiles (128 x 64, the default, and 64 x 64) at the GPT and Llama
   shapes: each against the plain version, against each other bit for
   bit (printed), timed; the autotune (PADDLE_TPU_AUTOTUNE=1, its cache
   in a temporary directory) times both on the first call, caches the
   pick and hits on the second; an env tile outranks the cache, a
   foreign cache entry is skipped and counted, an env tile the kernels
   lack raises.
3c. GPT with experts (models/gpt.py num_experts, parallel/moe.py) at
   the same widths and MOE_LAYERS = 4 of its 24 layers: 8 experts
   (Switch-Base-8's count), the switch gate, capacity factor 1.25, aux
   weight 0.01 (the reference's defaults), remat "full", the CE on its
   default two-pass route and the fused update forced (one launch over
   the 17 leaves). From one starting state (kept on the host): the
   switch and the gshard (top-2) step against the plain versions
   (losses of a forward and of a train step within 2e-3 relative; the
   tokens whose top-1 expert differs between the two forwards counted
   and printed, not gated: a bf16 difference in attention can move a
   near-tie token; the dropped share and the aux loss printed), each
   step's launches exactly flash 2L / L / L, ce_fwd 1, ce_bwd 1,
   leaf_update 1 over 17 leaves; 5-step switch trajectories on each
   (within 1e-2); 2 warm-up and 10 timed switch steps (step ms p50/p90,
   tokens/s, MFU counted from the active parameters, the formula
   printed, peak memory) with the launches asserted; a 2-step profile.
4. Llama training at TinyLlama-1.1B's widths (vocab 32000, hidden 2048,
   22 layers, 32 heads over 4 KV heads, FFN 5632, max_seq_len 2048; the
   head tied to wte, 1,034,512,384 parameters), batch 4 x 2048 tokens,
   remat on, bf16 activations, f32 parameters, with the registry's
   "fused_update" winner forced to "pallas" (the fused AdamW kernel) and
   the cross entropy on its default two-pass route. Then a primal-only
   eval loss under torch.no_grad(), which must launch the CE forward
   alone.
   Phases 3 and 4 each run: step 1's loss and gradients on the kernels
   and on their plain versions (losses within 2e-3 relative, every
   gradient leaf's cosine >= 0.999; each leaf's cosine printed beside
   the plain-vs-plain floor, and the leaves below it named); from one
   starting state (kept on
   the host), 5 steps on the kernels and PLAIN_STEPS = 3 on the plain
   versions (trajectories within 1e-2); 2 warm-up and 10 timed steps
   through make_train_step (step ms p50/p90, tokens/s, MFU, peak
   memory) with the exact kernel launches asserted; and 1 step under
   torch.profiler (device busy share, device time by kernel).
5. Serving: the int8 ServingEngine at the GPT width, 8 slots, 16
   requests (prompt lengths 16..512 from a seeded rng, 64 new tokens
   each, two of them sampled with top-k). Every request must end with
   "length", and the int8 kernel must launch exactly 97 times per
   prefill and per decode tick (24 layers x 4 leaves + the head). One
   prefill's logits and 16 greedy tokens from the kernel are held
   against the same forward built on the plain version; 16 decode ticks
   run under torch.profiler; a 2-request fp (quant="off") engine runs
   too. Both greedy streams are replayed teacher-forced through both
   versions on the decode path that made them: at every step the two
   versions' logits agree within 5% of the span; every int8 call of the
   kernel's replays (the prefill and each step, 97 a forward) lies
   within the f64 bound on its own bf16 input; and where the streams
   part, the first differing step is a one-bf16-step tie in both
   versions' logits, and the kernel leaves the plain stream nowhere
   else beyond such a tie. The f64 logits of the two tokens at the
   parting (at step 2 where the streams agree) are printed beside the
   kernel's and the plain version's.
5b. Llama serving at TinyLlama-1.1B widths and LLAMA_SERVE_LAYERS = 4
   of its 22 layers (phases 5b-5e; random weights drawn on the host
   from seed 0 at that depth): the int8
   ServingEngine, family "llama", 8 slots, max_len 2048, 16 requests
   (prompt lengths 16..1024 from a seeded rng, 64 new tokens each, two
   sampled with top-k), exactly 29 launches per prefill and per tick
   (4 layers x 7 leaves + the head), and the checks, profile and fp
   engine of phase 5, but for the one-step rule at a parting: there the
   Llama stack carries two faithful roundings apart by more than one
   bf16 step, and the greedy verdict rests on the f64 bound of every
   int8 call of both replays (29 a forward).
5c. Paged and speculative Llama serving at TinyLlama-1.1B widths, on
   phase 5b's host-drawn weights: the int8 engine with kv_layout
   "paged", page_size 16, prefill_chunk 256 and 513 pages (half the
   dense-equivalent 1025), 8 slots, max_len 2048, over 16 requests of
   PAGED_NEW = 16 new tokens (seed 7): a shared 512-token prefix and a
   suffix of
   16..512 tokens, request 0's suffix 256 tokens (48 full pages),
   requests 14 and 15 repeating request 0's prompt (every page mapped,
   the last one copied), requests 3 and 11 sampled with top-k. Then a
   dense engine on the same prompts, the paged engine with spec_decode
   "spec", gamma 4 and draft_layers 2, and the dense one with it. Each
   run: every request ends "length"; exactly 29 launches a prefill
   chunk (a prefill, dense) and a tick, 29 + 4 x (2 x 7 + 1) = 89 a
   spec tick; the page pool checked after every step (table references
   equal refcounts, every page free, cached or live, reservations
   conserved, no slot mapping a page past its position) and at the end
   empty of live pages and reservations; prefix hits, COW copies and
   chunks all > 0; tick ms p50/p90, prefill (chunk) ms p50/max,
   tokens/s, peak memory and pages, and the acceptance rate and tokens
   per spec tick (at random weights, which say nothing of a trained
   model's); a tick profile of the paged and the paged spec engine.
   Greedy streams are compared, paged against dense and each spec
   engine against the non-spec engine of its layout; at every
   parting both streams are replayed teacher-forced along the paths
   that made them (a verify-shaped window for spec) and phase 5b's
   verdict holds: every int8 call within the f64 bound, the two paths'
   logits and each replay's own tokens within 5% of the span.
5d. Multi-tick decode and the host KV tier at TinyLlama-1.1B widths, on
   the same weights: the engines of 5b (dense, its 16 requests, 64 new
   tokens) and 5c (paged, paged spec, dense spec, 5c's requests,
   PAGED_NEW tokens) at multi_tick=4, where
   a dispatch runs 4 ticks and, after each sampling flag's eager
   warm-up, is one CUDA graph replay. Each run: every request ends
   "length"; each warm-up launches exactly 4 x 29 (4 x 89 spec)
   int8 kernels, each capture records exactly as many, the replays
   launch the rest (graph_replays = dispatches - warm-ups, at most 2
   graphs); the pool checked after every step;
   every stream, greedy or sampled, equals the K = 1 engine's of its
   layout from 5b or 5c, or its parting passes 5b's verdict (a sampled
   stream's own tokens not held to the top logit); dispatch ms p50/p90,
   ms per tick, tokens/s beside the K = 1 engine's, capture ms, peak
   memory, and a profile of 4 replays (busy share, top kernels, each
   dispatch's time from CUDA events, and the int8 launches the profiler
   lists over the replays, checked at 99-100% of the engine's count:
   the profiler drops a few records late in the process). Then
   the host tier:
   8 families of a 512-token prefix and a 16..256-token suffix, 2
   requests each, 32 new tokens, served twice by the paged multi-tick
   engine with 257 pages and a 256 MiB host tier, without the tier, and
   with 1025 pages: spills and swap-ins > 0, the tier's streams equal
   the 1025-page engine's token for token and the tier-less engine's or
   each parting passes the verdict; bytes, drops, ms a swapped-in page,
   round-2 chunks and prefill p50 of each engine.
5e. Tensor-parallel Llama serving (ServingEngine(mesh=), parallel/
   layout.py ServingLayout): first the int8 kernel at M 8 on every
   leaf shape a tp2 rank holds (TP_LEAF_KN: q [2048, 1024], o [1024,
   2048], k/v [2048, 128], gate/up [2048, 2816], down [2816, 2048],
   the head [2048, 16000]), against its plain version (timed beside
   the library and the bound) and against the f64 bound, each call on
   its own input. Then 5b's int8 engine (TinyLlama widths, 4 layers,
   8 slots, max_len 2048) on a tp2 mesh over two spawned ranks (one
   card each over NCCL where there are two; on one card both share it
   over gloo, every tp collective an all-reduce through the host: the
   tick times measure the host link, not scaling), each rank cutting
   5b's int8 tree to its shards: 10 of 5b's 16 requests on the dense
   engine, K = 1, then 10 of 5c's (request 3 sampled; 14 and 15,
   repeating request 0's prompt, queued behind the 8 slots) on the paged
   engine with spec decode, 16 new tokens each. Each run:
   every request ends "length", each rank launches exactly 29 int8
   kernels a pass and 89 a spec tick and the threefry kernel once a
   sampled pass and tick, the pool checked after every step; both
   ranks' streams identical, and each equal to 5b's (dense) or 5c's
   paged spec engine's, or its parting passes 5b's verdict along the
   single-card path; tick ms p50/p90 a rank, the tp collectives a
   dispatch, peak memory a rank, and plan_serving_tp's pick for this
   model on 1 and on 2 devices.
5f. The serving engine's robustness and observability, on phase 5's GPT
   (the headline widths, all 24 layers, its host weights and their int8
   rewrite; `gpt_serving_chaos`, after phase 5): (a) 8 requests (two
   sampled) through the dense K = 1, the paged (chunks of 128), the spec
   (gamma 4, 2 draft layers) and the K = 4 graphed engines with
   telemetry off and on: the same bits, one pull a prefill and a
   dispatch, the same captures and replays, the TICK_FIELDS rows' tokens
   and `attended` against the host's mirrors, no poisoned row; the K = 1
   tick and the K = 4 dispatch timed off and on in mirrored order. (b)
   tools/chaos_serving.py's engine scenarios, each against the
   fault-free run of its engine and drive (4 requests of CHAOS_NEW = 8
   tokens on 4 slots, one sampled; 6 of CHAOS_NEW_LONG = 12 tokens, 2 of
   them queued, on the K = 4 engine, 4 of 12 on the spec one):
   nan_logits@2:1 (every 5f engine is int8, so it is quant_nan_logits
   too: the int8 counters), tick_stall@2:400 under a 0.2 s watchdog,
   prefill_raise@0, decode_raise@2, oom@2 (the oom_forensics dump), the
   queue floods (reject, shed_oldest), cancel with a deadline, on the
   dense K = 1 engine; nan_logits, tick_stall and decode_raise with
   retries=0 (the hard reset, then fresh streams equal the clean run's)
   on the K = 4 graphed one; paged_nan_poison, paged_pool_flood and
   cow_raise@0 on the paged one; spec_draft_nan and spec_nan_logits with
   full-depth drafts (gamma 2). Each: every request in one terminal
   reason and one terminal span, survivors' streams equal to the bit and
   the others prefixes, a flight dump where the fault is eventful, the
   graph captures at the clean run's count, the serving.* counters moved
   as the reference's scenario expects. (c) One request's span tree on
   the paged engine (queue, >= 2 prefill chunks, decode, a decode.tick a
   token, one terminal span; the chrome export loads) and a
   BurnRateMonitor fed the nan_logits run's export_slo_jsonl and
   poisoned count raising its alert. (d) Every run's int8 launches
   against its passes and dispatches (serving.quant_matmuls = the
   wrapper's + the replays'), its threefry launches against its draws.
6. The planner-driven dp×fsdp×tp train step (paddle_tpu_torch/parallel,
   models/facade.py make_train_step(mesh=, plan=)) at phase 4's
   configuration, from phase 4's starting state (seed 0, drawn again).
   6a: a 1-rank NCCL group, plan dp1×fsdp1×tp1, the fused update forced,
   its 5 trajectory steps through the device telemetry
   (profiler/telemetry.py instrument_train_step, MFU_FIELDS, a flush
   every 4 steps), the build and step 0 under the port's Profiler:
   its 5 losses equal to phase 4's kernel trajectory to the bit, its
   launches a step exactly phase 4's (flash 44 / 22 / 22, ce_fwd 1,
   ce_bwd 1, leaf_update 1 over 11 leaves), its p50 (5 plain steps)
   and peak beside phase 4's; exactly 2 pulls (the flush and the tail),
   every recorded loss the step's, nonfinite 0, param_norm within 1e-5
   and grad_norm (the moment identity) within 1e-4 of f64 norms (the
   gradient's from step.loss_and_grads before step 4), as many
   synchronizing calls a step (torch.cuda.set_sync_debug_mode) as the
   plain step, train.mfu within 15% of the MFU of the step its window
   timed (the plain steps' and phase 4's printed), the stream read
   by tools/telemetry_report.py, the Profiler's trace naming the three
   flash kernels and the facade.make_train_step span; then a 256 x 2048
   batch must raise torch.OutOfMemoryError in the forward, leave the
   oom_forensics flight dump naming every params and moment leaf, and
   leave torch.cuda.memory_allocated() as it was.
   6b: two spawned
   ranks (one card each over NCCL where there are two or more cards;
   on one card, both on it over gloo, every collective an all-reduce
   through parallel/collective.py's route for CUDA tensors), the plans
   tp2 (dp1×fsdp1×tp2) and fsdp2 (dp1×fsdp2×tp1) at the same global
   batch and widths, SHARDED_LAYERS = 2 layers deep (every collective
   crosses the host on one card, in bytes that grow with the depth),
   held to the unsharded step at that depth from the same state (seed
   0), which rank 0 runs first: step 1's loss within 2e-3 relative of
   the unsharded one's and every gradient leaf's cosine >= 0.999
   against the unsharded step 1 (phase 4's tolerances), the 5-step
   trajectory within 1e-2 of the unsharded one's, each leaf's step-1
   gradient norm within 1e-2 of the unsharded one's (a wrong loss
   scale or a sum where a mean belongs moves it by 2x; cosine and
   AdamW cannot see it), exactly the unsharded step's launches a step
   on each rank, each rank's heads (tp2: 16 query and 2 KV), its
   params and moments at most 51% of the unsharded state's, its peak and
   step times (marked as taken with both ranks on one card where they
   were). The shapes each rank's flash, CE and AdamW kernels launch at
   are recorded and must be among the shapes phases 2b, 2d and 2e held
   against the plain versions (SHARDED_PLANS' local shapes are added
   to those checks). The route, backend and card count are printed; a
   failure in a rank fails the phase. In the same two-rank world, the
   pipelined step (parallel/pipeline_train.py) on the plan
   dp1×fsdp1×tp1×pp2 with 4 microbatches of [1, 2048]: 1 layer a
   stage, the 1F1B schedule, the stage handoffs on the pp group's route
   (on one card "gloo_cuda_via_all_reduce"), the vocab-parallel loss in
   stock torch; held to the same gates, with the launches and state
   bytes its plan gives (sharded_launches: flash 8 / 4 / 4 a step a
   rank, no CE kernel, the update on the stage's 11 leaves; its
   params and moments exactly the bytes of shard_shapes, half of the
   stacked leaves and the whole wte and norm_f), its schedule's bubble
   (the 1F1B timeline's busy slots) equal to (pp-1)/(m+pp-1) and
   within 1.5x of the planner's (pp-1)/m, and one more step with every
   handoff timed between two synchronizes (the schedule's gaps, the
   route's cost, and the measured share of the step spent waiting in
   handoffs).
6c. Checkpoints (paddle_tpu_torch/parallel/checkpoint.py). (a) Phase
   4's configuration and starting state on one rank: 2 steps,
   CheckpointManager.save_async of the 12.4 GB state, step 3 while the
   writer runs, steps 4-5, wait() and verify_checkpoint, the snapshot
   loaded into fresh buffers with template=, steps 3-5 again: equal to
   the uninterrupted ones to the bit; the bytes, save_async's host ms
   and its copies' device ms (and again into the kept pinned buffers),
   the writer's seconds and GB/s, verify and restore seconds, the free
   disk before and after, and the resilient guard's copy and check ms
   on that state (the check must catch a planted inf, -inf and nan);
   the monitor counts the save, snapshot, verify and load once each,
   and the span log holds their spans.
   (b) Inside 6b: the fsdp2 plan saves synchronously after its step 2,
   each rank its half, out of the timed steps; after the pp2 plan's
   steps the snapshot is restored onto pp2: every params, m and v
   marginal (a leaf's sum of squares at each index of each dim, added
   over the ranks) equals the saved state's within 1e-9, and 3 steps
   run within 1e-3 of fsdp2's steps 3-5, every rank the same losses.
   (c) Inside 6b too: GPT at the headline widths, SHARDED_LAYERS deep,
   on hand-built meshes (the planner plans neither axis): "ep2" (mesh
   {ep 2}, phase 3c's experts, 4 a rank), "sp2_ring" and "sp2_ulysses"
   (mesh {sp 2}, context_parallel "ring" / "ulysses", 8 heads a
   Ulysses rank), each held to the unsharded step of its config with
   context_parallel "none", which rank 0 runs first, by 6b's gates over
   GPT_PLAN_STEPS = 2 steps, with exactly gpt_step_launches a step a
   rank (no flash launch under the ring, whose f32 chunk updates are
   plain torch), the flash kernels at the plan's shape (a Ulysses
   rank's [8, 1024, 8, 64], checked in phase 2b) and the CE pair at
   [8192, 32768] (phase 2d); each plan's ms a step a rank and the
   collective bytes a rank hands to torch.distributed a step printed.
   The resilience drill (parallel/resilience.py): one rank,
   TinyLlama widths at DRILL_LAYERS = 2 layers, a ResilientTrainer (keep 2 snapshots,
   one every 2 steps, rollback after 3 skips, a 120 s watchdog) clean
   and under nan@3:3: each skip leaves every param and moment equal to
   the bit, the rollback to step 2 re-runs the clean run's losses and
   final state to the bit with the device telemetry on (RESILIENT_FIELDS:
   ok 0 on exactly the three skipped steps); a 2 s stall under a 0.5 s
   budget with no retries raises StepHungError; the monitor counts 3
   skips, 1 rollback, 1 watchdog hang, and the rollback and hang flight
   dumps load. Each part deletes its snapshots in a
   finally and fails when the disk has less free space than it writes.
6d. The elastic drill (parallel/elastic.py, the port's launcher
   python -m paddle_tpu_torch.distributed.launch, with this script as
   its worker, `--elastic-worker MODE DIR`): TinyLlama widths at
   DRILL_LAYERS = 2 layers, fsdp2 over two ranks (on one card both share
   it over gloo).
   First an ElasticTrainer with restart_on_loss under device_loss@2:1
   (a snapshot every 2 steps) runs steps 0-1; at step 2's boundary the
   workers write the world spec {n_devices: 1} and exit 101; the
   launcher relaunches one rank, which plans onto fsdp1, restores ckpt-2
   and runs step 2. It equals, to the bit, a clean one-rank restore
   of ckpt-2 run in this process. The seconds from the loss to the first
   resumed step (detection and exit, the respawn, the boot, the
   restore, the step) and the bytes restored are printed. Then two
   ranks again: the uninterrupted run, 3 steps under an 8 s step budget
   with a 1 s straggler at step 2 (which must not replan), whose step 2
   the resumed one lies within 1e-3 of; after a snapshot at step 3, a
   10 s collective hang past the budget must replan, in-process: rank 1
   declared lost leaves with exit 103, rank 0 re-forms a world of one on
   a fresh store, restores that snapshot onto fsdp1 and runs step 3.
   Each worker's kernel launches must be its steps' (4 flash forwards,
   2 of each backward, one CE pair and one update launch over 11 leaves
   a step). Every worker's flight directory is the one the launcher set
   (<log dir>/flight); each worker that met the loss or the hang left
   its elastic_device_loss dump there (the loss's also
   elastic_degraded_exit) carrying the train.elastic.* counters, and
   the hang's survivor reads one replan. The launcher runs bound to the
   script's life and its workers to the launcher's.
7. The seconds each phase took, the kernels line (the eight ported
   kernels and the threefry bits kernel, launches from 6c and the
   drill included),
   the card line, and as the last
   line {"ok": true, "device": {"platform": "gpu", "kind": ..., "count":
   1}}.

No process the script starts outlives it: the spawned ranks and 6d's
launcher are bound to its life (PR_SET_PDEATHSIG), the launcher's
workers to the launcher's; a SIGTERM, or TIME_LIMIT_S - STOP_MARGIN_S
seconds from the start (exit 3), stops everything below the script, and
at its end it stops whatever is left.

float32 matmuls run in full float32 here: TF32 is switched off for
matmul and cuDNN, so the plain versions are exact-f32 references.
"""
import collections
import contextlib
import functools
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
# when this process imported the script: phase 6d's relaunched worker
# times its relaunch from here
T_IMPORT = time.time()

# H100 SXM published peaks (dense bf16, HBM3), used for the bounds
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

FULL = dict(vocab_size=32768, hidden_size=1024, num_layers=24, num_heads=16,
            max_seq_len=1024)
TRAIN_BATCH, TRAIN_SEQ = 8, 1024          # bench.py's tpu rung
# TinyLlama-1.1B (TinyLlama/TinyLlama-1.1B-intermediate-step-1431k-3T
# config.json; the repo's Llama ties the head to wte)
LLAMA = dict(vocab_size=32000, hidden_size=2048, num_layers=22,
             num_heads=32, num_kv_heads=4, max_seq_len=2048,
             rope_theta=10000.0, rms_eps=1e-5)
LLAMA_BATCH, LLAMA_SEQ = 4, 2048
# the Llama serving phases 5b-5e run 4 of the 22 layers: the same widths
# and leaf shapes at a cut depth, so that the script ends well inside
# TIME_LIMIT_S on a slower host too (PERF.md)
LLAMA_SERVE_LAYERS = 4
_D, _L, _F, _KV = 2048, 22, 5632, 4 * 64


def llama_leaves(L):
    """{leaf: shape} of the TinyLlama-width tree at L layers."""
    return {"wte": (32000, _D), "norm_f": (_D,), "attn_norm": (L, _D),
            "q_w": (L, _D, _D), "k_w": (L, _D, _KV), "v_w": (L, _D, _KV),
            "o_w": (L, _D, _D), "ffn_norm": (L, _D), "gate_w": (L, _D, _F),
            "up_w": (L, _D, _F), "down_w": (L, _F, _D)}


LLAMA_LEAVES = llama_leaves(_L)
# phase 6b's depth: the TinyLlama widths at 2 layers (1 a stage under
# pp2). Every collective of its plans crosses the host
# on one card (gloo), in bytes that grow with the depth; at full depth
# 6b took 233.0-280.3 s of TIME_LIMIT_S, at 4 layers 67.5-102.3 (PERF.md)
SHARDED_LAYERS = 2
ADAMW = dict(lr=3e-4, beta1=0.9, beta2=0.95, eps=1e-8, weight_decay=0.1)
# the seconds the whole script must finish in, its kernels' builds
# included
TIME_LIMIT_S = 1200
LEAF_KN = {"qkv_w": (1024, 3072), "attn_out_w": (1024, 1024),
           "mlp_up_w": (1024, 4096), "mlp_down_w": (4096, 1024),
           "head": (1024, 32768)}
# the Llama serving path's int8 leaves at TinyLlama widths; a name "a/b"
# stands for two leaves of one shape
LLAMA_LEAF_KN = {"q_w/o_w": (_D, _D), "k_w/v_w": (_D, _KV),
                 "gate_w/up_w": (_D, _F), "down_w": (_F, _D),
                 "head": (_D, 32000)}
M_VALUES = (8, 128, 512)
# rows of the f64 bound check: decode (8 slots; 16 takes the 16-row
# tile) and prefill
F64_M_VALUES = (8, 16, 128, 512)
# extra rows of both checks at the Llama leaf shapes: the paged engine's
# spec verify pass (8 slots x (gamma 4 + 1) = 40 rows), its prefill chunk
# (256) and the dense path's largest prefill bucket (prompts up to 1024
# tokens)
LLAMA_EXTRA_M = (40, 256, 1024)


def pass_calls(leaf_kn, L):
    """{leaf: int8 calls a full pass}: each block leaf once a layer, the
    head once."""
    return {leaf: 1 if leaf == "head" else L * len(leaf.split("/"))
            for leaf in leaf_kn}


def f64_oracle(torch, x, w_q, scale, weights64=None):
    """The f64 value of (x @ w_q) * scale from the same x [..., K] and
    its bound: (y64 [M, N], ulp_bf16(y64), ulp_bf16(y64) + K 2^-24
    ((|x| @ |w_q|) scale)_64). The first term is the one rounding to
    bf16; the second bounds an f32 sum of K exact products in any order,
    so an element near cancellation passes for a correct kernel, while a
    dropped or doubled split or a wrong scale is orders past it.
    `weights64`, a dict, keeps each weight's f64 copy and its absolute
    value across calls (a replay calls every weight many times)."""
    K = w_q.shape[0]
    x64, s64 = x.reshape(-1, K).double(), scale.double()
    key = (w_q.data_ptr(), tuple(w_q.shape))
    pair = None if weights64 is None else weights64.get(key)
    if pair is None:
        w64 = w_q.double()
        pair = (w64, w64.abs())
        if weights64 is not None:
            weights64[key] = pair
    y64 = (x64 @ pair[0]) * s64
    absprod = (x64.abs() @ pair[1]) * s64
    _, e = torch.frexp(y64.abs().clamp_min(2.0 ** -126))
    ulp = torch.ldexp(torch.ones_like(y64), e - 8)     # bf16: 8 bits
    return y64, ulp, ulp + K * 2.0 ** -24 * absprod


def f64_verdict(torch, y, oracle):
    """How far y [..., N] lies from the oracle's y64: the largest |y -
    y64| in bf16 ulps of y64 and as a share of the bound; ok when every
    element is finite and within the bound."""
    y64, ulp, bnd = oracle
    err = (y.reshape(y64.shape).double() - y64).abs()
    share = err / bnd
    return {"max_ulps": float((err / ulp).max()),
            "max_bound_share": float(share.max()),
            "ok": bool(torch.isfinite(y).all()) and bool((share <= 1).all())}


def qmm_f64_check(torch, qm, dev):
    """Phase 2, the int8 kernel against the f64 value of its own inputs
    at every leaf shape of both serving paths and M in F64_M_VALUES: on
    `_plan`'s plan and, where that splits K, on the unsplit plan too; the
    plain version beside it. Raises unless every kernel element is within
    the bound. Returns the worst shares and ulps."""
    g = torch.Generator(device=dev).manual_seed(11)
    sm = qm._sm_count(dev)
    worst = {"kernel_max_ulps": 0.0, "kernel_max_bound_share": 0.0,
             "plain_max_ulps": 0.0, "plain_max_bound_share": 0.0}
    shapes = sorted(set(LEAF_KN.values()) | set(LLAMA_LEAF_KN.values()))
    llama_shapes = sorted(set(LLAMA_LEAF_KN.values()))
    for M in F64_M_VALUES + LLAMA_EXTRA_M:
        for K, N in shapes if M in F64_M_VALUES else llama_shapes:
            qmm_f64_row(torch, qm, dev, g, sm, M, K, N, worst)
    log(json.dumps({"phase": "qmm_f64_bound", "shapes": len(shapes),
                    "M": F64_M_VALUES, "llama_M": LLAMA_EXTRA_M, **worst,
                    "bound": "ulp_bf16(y64) + K*2^-24*((|x|@|w|)*scale)_64"}))
    return worst


def log(msg):
    print(msg, flush=True)


# the script's own processes: every process it starts (the spawned ranks
# of 5e and 6b, 6d's launcher, whose workers the launcher's boot shim
# binds to it) is bound to the script's life, and the script stops what
# is left below it before it exits, however it ends
SCRIPT_PID_ENV = "CHIP_SMOKE_PID"
# the script stops itself this many seconds before TIME_LIMIT_S (from its
# import), so that a run that overruns ends with nothing left running
STOP_MARGIN_S = 30


def bind_to_script():
    """On Linux, have the kernel SIGKILL this process when the script's
    main process ($CHIP_SMOKE_PID), which started it, ends
    (PR_SET_PDEATHSIG): a killed script leaves no rank or launcher
    behind. A process whose script ended before the binding exits at
    once. Does nothing outside a run of the script."""
    parent = int(os.environ.get(SCRIPT_PID_ENV) or 0)
    if not parent or not sys.platform.startswith("linux"):
        return
    import ctypes
    import signal
    ctypes.CDLL(None, use_errno=True).prctl(1, int(signal.SIGKILL), 0, 0,
                                            0)     # PR_SET_PDEATHSIG
    if os.getppid() != parent:
        os._exit(1)


def _proc_stat(pid):
    """(state, parent pid) of a process from /proc, None when it is gone."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
    except (OSError, IndexError):
        return None
    return fields[0], int(fields[1])


def descendants():
    """Pids of every live (not zombie) process below this one."""
    parents = {}
    for name in os.listdir("/proc"):
        st = _proc_stat(name) if name.isdigit() else None
        if st is not None and st[0] != "Z":
            parents[int(name)] = st[1]
    out, frontier = [], {os.getpid()}
    while frontier:
        frontier = {p for p, pp in parents.items() if pp in frontier}
        out += sorted(frontier)
    return out


def _cmdline(pid):
    try:
        with open(f"/proc/{pid}/cmdline", "rb") as f:
            return f.read().replace(b"\0", b" ").decode(errors="replace")
    except OSError:
        return ""


# multiprocessing's resource tracker (started for 5e's and 6b's spawned
# ranks) ends by itself when the script's process does; killed before
# that, the interpreter's exit would start a new one
RESOURCE_TRACKER = "multiprocessing.resource_tracker"


def stop_descendants(keep=()):
    """SIGKILL every process below this one but those whose command line
    holds a string of `keep`, and wait, up to 20 s, until each has ended
    (a zombie, which holds nothing, counts as ended). Returns {pid:
    command line} of those it stopped."""
    import signal
    stopped = {pid: _cmdline(pid) for pid in descendants()}
    stopped = {pid: cmd for pid, cmd in stopped.items()
               if not any(k in cmd for k in keep)}
    pids = list(stopped)
    for pid in pids:
        try:
            os.kill(pid, signal.SIGKILL)
        except OSError:
            pass
    deadline = time.time() + 20.0
    while time.time() < deadline:
        try:
            while os.waitpid(-1, os.WNOHANG)[0]:      # reap our children
                pass
        except ChildProcessError:
            pass
        if all((_proc_stat(p) or "Z")[0] == "Z" for p in pids):
            break
        time.sleep(0.1)
    return stopped


def stop_before_limit():
    """Bind what the script starts to it ($CHIP_SMOKE_PID), stop
    everything below it on SIGTERM, and start a daemon thread that, at
    TIME_LIMIT_S - STOP_MARGIN_S from the import, says so on the standard
    error, stops everything below the script and ends it with exit 3."""
    import signal
    import threading
    os.environ[SCRIPT_PID_ENV] = str(os.getpid())

    def on_term(signum, frame):
        stop_descendants()
        os._exit(128 + signum)
    signal.signal(signal.SIGTERM, on_term)

    def watch():
        time.sleep(max(0.0, T_IMPORT + TIME_LIMIT_S - STOP_MARGIN_S
                       - time.time()))
        print(f"[chip_smoke] {TIME_LIMIT_S - STOP_MARGIN_S} s since the "
              f"start: stopping the run, and every process it started, "
              f"before its {TIME_LIMIT_S} s limit", file=sys.stderr,
              flush=True)
        stop_descendants()
        os._exit(3)
    threading.Thread(target=watch, name="chip_smoke_deadline",
                     daemon=True).start()


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def bound(M, K, N):
    """Least time (ms) for (x[M,K] bf16 . w[K,N] int8) * scale[N] f32 ->
    y[M,N] bf16: each input read once and the output written once over
    the HBM rate, or the 2MKN operations over the bf16 peak."""
    return bound_ms(2.0 * M * K * N, K * N + 2 * M * K + 2 * M * N + 4 * N)


_SIDE_STREAM = []


def graph_ms(torch, fn, n_iters):
    """Device time per call: capture n_iters calls into a CUDA graph,
    replay it (warm), and time one replay with CUDA events. The warm-up
    runs on one side stream kept for every call: cuBLAS keeps a
    workspace for each stream it has run on, so a new stream a call
    would leave ~32 MiB allocated each time."""
    if not _SIDE_STREAM:
        _SIDE_STREAM.append(torch.cuda.Stream())
    s = _SIDE_STREAM[0]
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        for i in range(3):
            fn(i)
    torch.cuda.current_stream().wait_stream(s)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for i in range(n_iters):
            fn(i)
    g.replay()
    torch.cuda.synchronize()
    reps = 5
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * n_iters)


def qmm_f64_row(torch, qm, dev, g, sm, M, K, N, worst, tag=None):
    """One shape of the f64 bound check: the kernel on `_plan`'s plan
    (and unsplit where that splits K) and the plain version, each held
    to the f64 value of its own input; `worst` takes the largest shares
    and ulps. Raises unless every kernel element is within the bound."""
    x = torch.randn(M, K, generator=g, device=dev).to(torch.bfloat16)
    w = torch.randint(-127, 128, (K, N), generator=g, device=dev,
                      dtype=torch.int8)
    s = torch.rand(N, generator=g, device=dev) * 1e-2 + 1e-4
    oracle = f64_oracle(torch, x, w, s)
    plain = f64_verdict(torch, qm.quant_matmul_ref(x, w, s), oracle)
    plans = {"plan": qm._plan(M, K, N, sm)}
    if plans["plan"].splits > 1:
        plans["unsplit"] = qm._plan(M, K, N, sm, max_splits=1)
    line = {"phase": "qmm_f64_bound", "M": M, "K": K, "N": N,
            "plain": plain}
    if tag:
        line["path"] = tag
    for name, plan in plans.items():
        line[name] = dict(f64_verdict(torch, qm._launch(
            x, w, s, plan=plan), oracle), splits=plan.splits)
        for k in ("max_ulps", "max_bound_share"):
            worst["kernel_" + k] = max(worst["kernel_" + k], line[name][k])
    for k in ("max_ulps", "max_bound_share"):
        worst["plain_" + k] = max(worst["plain_" + k], plain[k])
    log(json.dumps(line))
    bad = [n for n in plans if not line[n]["ok"]]
    if bad:
        raise AssertionError(
            f"quant_matmul outside the f64 bound at M={M} K={K} N={N} on "
            f"the {bad} plan(s): {json.dumps(line)}")
    return line


def qmm_row(torch, qm, dev, g, M, K, N, tag=None):
    """One shape of the int8 kernel's check: the kernel against its
    plain version (the same bits twice, within the rounding tolerance),
    and its time beside the plain version's, the library's and the
    bound. Returns the row."""
    # cycle enough weight copies (>= 150 MB) that every call
    # finds its weight cold in the 50 MB L2, as the serving tick
    # does with its 97 different weights
    n_copies = max(2, math.ceil(150e6 / (K * N)))
    x = torch.randn(M, K, generator=g, device=dev).to(torch.bfloat16)
    ws = [torch.randint(-127, 128, (K, N), generator=g, device=dev,
                        dtype=torch.int8) for _ in range(n_copies)]
    ss = [torch.rand(N, generator=g, device=dev) * 1e-2 + 1e-4
          for _ in range(n_copies)]
    y = qm.quant_matmul(x, ws[0], ss[0])
    # a fixed reduction order (split-K included): the same bits
    # from a second call
    again = qm.quant_matmul(x, ws[0], ss[0])
    ref = qm.quant_matmul_ref(x, ws[0], ss[0])
    torch.cuda.synchronize()
    same_bits = torch.equal(y.view(torch.int16),
                            again.view(torch.int16))
    if not same_bits:
        raise AssertionError(
            f"quant_matmul gives other bits on a second call at "
            f"M={M} K={K} N={N}")
    # tolerance: both round an f32 value to bf16 once (at most
    # one bf16 step apart, 2^-7 relative), and the two f32 sums
    # differ only by summation order over K (K * 2^-24 of the
    # sum of |products|)
    absprod = (x.float().abs() @ ws[0].float().abs()) * ss[0]
    tol = 2.0 ** -7 * ref.float().abs() + K * 2.0 ** -24 * absprod
    err = (y.float() - ref.float()).abs()
    max_err = float(err.max())
    if not bool((err <= tol).all()) or not bool(
            torch.isfinite(y).all()):
        raise AssertionError(
            f"quant_matmul kernel disagrees with its plain version "
            f"at M={M} K={K} N={N}: max |err| {max_err}, worst "
            f"err/tol {float((err / tol).max())}")
    wb = [(w.float() * s).to(torch.bfloat16) for w, s in zip(ws, ss)]
    n_it = 4 * n_copies
    kernel_ms = graph_ms(torch, lambda i: qm.quant_matmul(
        x, ws[i % n_copies], ss[i % n_copies]), n_it)
    plain_ms = graph_ms(torch, lambda i: qm.quant_matmul_ref(
        x, ws[i % n_copies], ss[i % n_copies]), n_it)
    library_ms = graph_ms(torch, lambda i: torch.matmul(
        x, wb[i % n_copies]), n_it)
    b_ms, b_by = bound(M, K, N)
    row = {"phase": "kernel_check", "kernel": "quant_matmul",
           "M": M, "K": K, "N": N, "kernel_ms": kernel_ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "library": "torch.matmul(x, w_bf16), weight dequantized "
                      "to bf16 beforehand (reads 2x the weight "
                      "bytes; a yardstick the port never calls)",
           "bound_ms": b_ms, "bound_by": b_by,
           "roofline_share": b_ms / kernel_ms,
           "vs_library": kernel_ms / library_ms,
           "max_abs_err": max_err, "same_bits_twice": same_bits,
           "plan": qm._plan(M, K, N, qm._sm_count(dev))._asdict(),
           "design": QMM_DESIGN,
           "tolerance": "2^-7*|ref| + K*2^-24*(|x|@|w|)*scale"}
    if tag:
        row["path"] = tag
    log(json.dumps(row))
    del ws, ss, wb
    return row


def kernel_check(torch, qm, dev):
    """Phase 2, at the leaf shapes of both serving paths. Returns
    {(M, K, N): row}."""
    g = torch.Generator(device=dev).manual_seed(0)
    rows = {}
    shapes = list(LEAF_KN.values()) + [
        kn for kn in LLAMA_LEAF_KN.values() if kn not in LEAF_KN.values()]
    llama_shapes = list(dict.fromkeys(LLAMA_LEAF_KN.values()))
    for M in M_VALUES + LLAMA_EXTRA_M:
        for K, N in shapes if M in M_VALUES else llama_shapes:
            rows[(M, K, N)] = qmm_row(torch, qm, dev, g, M, K, N)
    for fam, leaf_kn, L in (("gpt", LEAF_KN, FULL["num_layers"]),
                            ("llama", LLAMA_LEAF_KN, LLAMA["num_layers"])):
        agg = tick_aggregate(rows, leaf_kn, L)
        log(json.dumps({"phase": "kernel_check", "kernel": "quant_matmul",
                        "family": fam,
                        "per": f"one {fam} decode tick at M=8: "
                               f"{pass_calls(leaf_kn, L)}, {agg['calls']} "
                               "calls",
                        **agg, "roofline_share": agg["bound_ms"]
                        / agg["kernel_ms"],
                        "vs_library": agg["kernel_ms"] / agg["library_ms"]}))
    return rows


def tick_aggregate(rows, leaf_kn, L):
    """The launches of one decode tick at M=8 (each block leaf L times,
    the head once: GPT 97, Llama 155), summed per metric; the bound from
    the summed bytes and operations."""
    calls = pass_calls(leaf_kn, L)
    agg = {"calls": sum(calls.values())}
    for key in ("kernel_ms", "plain_ms", "library_ms"):
        agg[key] = sum(calls[leaf] * rows[(8,) + kn][key]
                       for leaf, kn in leaf_kn.items())
    ops = sum(calls[leaf] * 2.0 * 8 * k * n
              for leaf, (k, n) in leaf_kn.items())
    nbytes = sum(calls[leaf] * (k * n + 2 * 8 * k + 2 * 8 * n + 4 * n)
                 for leaf, (k, n) in leaf_kn.items())
    agg["bound_ms"], agg["bound_by"] = bound_ms(ops, nbytes)
    agg["bound_bytes"] = nbytes
    return agg


def ptxas_summary(report):
    """One line per compiled kernel from nvcc's -Xptxas -v report:
    registers, shared memory and spills."""
    out, name, spill = [], None, ""
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name, spill = m.group(1), ""
            name = name[name.find("_cu_") + 4:] if "_cu_" in name else name
        elif name and "spill" in line:
            spill = line.strip()
        elif name and "Used" in line:
            out.append(f"{name[:70]}: {line.split(':', 1)[1].strip()}; "
                       f"{spill}")
    return out


# the D = 64 bf16 forward at both of its q tiles (128 rows, 64 rows)
FLASH_NO_SPILL = ("flash_fwd_kernelILi64ELi2E", "flash_fwd_q64_kernelILi64E",
                  "flash_bwd_dq_kernelILi64E", "flash_bwd_dkv_kernelILi64E")
# the bf16 dequant-matmul's three tile heights (8, 16 and 64 rows)
QMM_NO_SPILL = ("qmm_mma_kernelILi1E", "qmm_mma_kernelILi2E",
                "qmm_mma_kernelILi8E")
QMM_DESIGN = ("mma.sync bf16 (y^T = w^T x^T), int8 -> bf16 by byte "
              "permute, cp.async stages, deterministic split-K at M <= 16")


def check_no_spills(report, names=FLASH_NO_SPILL):
    """Raise unless nvcc's -Xptxas -v report shows each named kernel
    (a mangled-name fragment) compiled with no spill stores or loads."""
    found = {}
    name = None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = next((n for n in names if n in m.group(1)), None)
        elif name and "spill" in line:
            found[name] = line.strip()
            name = None
    bad = {n: found.get(n) for n in names
           if not re.search(r"\b0 bytes spill stores, 0 bytes spill loads",
                            found.get(n) or "")}
    if bad:
        raise AssertionError(f"ptxas reports spills (or no entry): {bad}")


def event_ms(torch, fn, n_iters=10):
    """Device time per call from CUDA events around n_iters calls, after
    2 warm-up calls (each call here runs >= tens of microseconds, so
    launch overhead is a small share)."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n_iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n_iters


def bound_ms(ops, nbytes):
    """Least time (ms): the larger of the operations over the bf16 tensor
    peak and the bytes over the HBM rate, and which of the two it is."""
    t_ops, t_bytes = ops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes
                                       else "bytes")


# phase 6b's plans of the Llama step on two ranks, by plan name (the
# pipelined one with its microbatches: the planner's default, 4·pp = 8,
# does not divide the batch of 4), and the (query heads, KV heads) each
# rank holds under each
SHARDED_PLANS = {"dp1_fsdp1_tp2": {"dp": 1, "fsdp": 1, "tp": 2},
                 "dp1_fsdp2_tp1": {"dp": 1, "fsdp": 2, "tp": 1},
                 "dp1_fsdp1_tp1_pp2": {"dp": 1, "fsdp": 1, "tp": 1,
                                       "pp": 2, "microbatches": 4}}
SHARDED_HEADS = {"dp1_fsdp1_tp2": (16, 2), "dp1_fsdp2_tp1": (32, 4),
                 "dp1_fsdp1_tp1_pp2": (32, 4)}
# phase 6c (b): 6b's plan that saves after its step 2, and the plan that
# restores that snapshot after its own steps and runs RESUME_STEPS more
CKPT_SAVE_PLAN, CKPT_LOAD_PLAN = "dp1_fsdp2_tp1", "dp1_fsdp1_tp1_pp2"
RESUME_STEPS = 3
# 6c (b)'s gates: the resumed losses against fsdp2's own steps 3-5
# (relative; runs on an H100 read 1.79e-5, the same bits each run), and
# each full-leaf marginal of the restored state against the saved one's
# (relative; f64 sums in another order differ by ~1e-15)
RESUME_TOL, MARGINAL_RTOL = 1e-3, 1e-9


def plan_pp(name):
    return SHARDED_PLANS[name].get("pp", 1)


def sharded_rows(name):
    """Rows of the global batch a rank of plan `name` trains on."""
    axes = SHARDED_PLANS[name]
    return LLAMA_BATCH // (axes["dp"] * axes["fsdp"])


def kernel_rows(name):
    """Rows one kernel launch of plan `name` sees: a microbatch's under
    pp, else the rank's."""
    return sharded_rows(name) // SHARDED_PLANS[name].get("microbatches", 1)


# the Llama step's attention on one rank of each plan, [B, S, H, 64]
SHARDED_ATTN = {name: (kernel_rows(name), LLAMA_SEQ, SHARDED_HEADS[name][0],
                       LLAMA["hidden_size"] // LLAMA["num_heads"], None)
                for name in SHARDED_PLANS}
# phase 6b's GPT plans (GPT_PLANS): a Ulysses rank of sp2 runs the flash
# kernels on half the heads over the whole sequence
SHARDED_ATTN["gpt_sp2_ulysses"] = (
    TRAIN_BATCH, TRAIN_SEQ, FULL["num_heads"] // 2,
    FULL["hidden_size"] // FULL["num_heads"], None)
# (B, S, H, D, kv_len): the GPT train step's attention, a ragged S with
# a kv_len bound, head dim 128 (the 6.7B/13B head width), the Llama
# train step's (32 query heads, the 4 KV heads repeated to match), and
# the Llama step's on one rank of each of phase 6b's plans
ATTN_SHAPES = [(8, 1024, 16, 64, None), (8, 1000, 16, 64, 900),
               (8, 1024, 8, 128, None), (4, 2048, 32, 64, None)] + [
    sh for sh in SHARDED_ATTN.values()]
ATTN_MAIN = ATTN_SHAPES[0]
ATTN_LLAMA = ATTN_SHAPES[3]
# how each attention kernel computes its products on bf16 operands
ATTN_DESIGN = {"flash_fwd": "mma.sync bf16",
               "flash_bwd_dq": "mma.sync bf16",
               "flash_bwd_dkv": "mma.sync bf16"}


def live_pairs(S, kv_len):
    """(q, k) pairs a causal attention over S rows with keys below
    kv_len computes: the work this run's data needs."""
    kl = S if kv_len is None else kv_len
    return sum(min(q + 1, kl) for q in range(S))


def flash_tol(ref):
    """Elementwise tolerance of a bf16 flash kernel's output against its
    plain version, [B, S, H, D]: 2^-6 of the entry and 2^-6 of its row's
    rms over D (2 to 4 bf16 steps: each side rounds its result once, and
    p and ds once before their products, at places that differ by the
    softmax scale: the kernel scales dq and dk at the end, the plain
    version scales ds first), plus 2^-10 of the tensor's rms for rows
    that are zero but for f32 rounding noise (dq of the first causal
    row). Rows differ in scale by 10x and more (a causal row attends to
    1 to S keys), so the rms is taken per row; an error of an entry's
    typical size fails."""
    r = ref.float()
    row = r.square().mean(-1, keepdim=True).sqrt()
    return (2.0 ** -6 * (r.abs() + row)
            + 2.0 ** -10 * r.square().mean().sqrt()).clamp_min(1e-30)


def attention_check(torch, dev):
    """Phase 2b. Returns {(B, S, H, D, kv_len): {kernel: row}}."""
    import torch.nn.functional as F
    from paddle_tpu_torch.kernels import flash_attention as fa
    ops = torch.ops.paddle_tpu_torch
    out_rows = {}
    for B, S, H, D, kv_len in ATTN_SHAPES:
        g = torch.Generator(device=dev).manual_seed(S + D)
        qkv = torch.randn(B, S, 3, H, D, generator=g,
                          device=dev).to(torch.bfloat16)
        q, k, v = qkv.unbind(2)                 # strided views
        do = torch.randn(B, S, H, D, generator=g,
                         device=dev).to(torch.bfloat16)
        klen = S if kv_len is None else kv_len
        out, lse = fa.mha_fwd(q, k, v, causal=True, kv_len=kv_len)
        grads = fa.mha_bwd(q, k, v, out, lse, do, causal=True,
                           kv_len=kv_len)
        r_out, r_lse = fa.mha_fwd_ref(q, k, v, True, kv_len)
        r_grads = fa.mha_bwd_ref(q, k, v, out, lse, do, True, kv_len)
        torch.cuda.synchronize()
        errs, over = {}, {}
        for name, got, ref in (("out", out, r_out), ("dq", grads[0],
                                                      r_grads[0]),
                               ("dk", grads[1], r_grads[1]),
                               ("dv", grads[2], r_grads[2])):
            err = (got.float() - ref.float()).abs()
            errs[name] = float(err.max())
            over[name] = float((err / flash_tol(ref)).max())
            if not bool(torch.isfinite(got).all()):
                over[name] = math.inf
        lse_err = float((lse - r_lse).abs().max())
        # the backward pair is two passes without atomics: a second run
        # on the same inputs gives the same bits
        again = fa.mha_bwd(q, k, v, out, lse, do, causal=True,
                           kv_len=kv_len)
        same_bits = all(torch.equal(a.view(torch.int16), b.view(torch.int16))
                        for a, b in zip(grads, again))
        out2, lse2 = fa.mha_fwd(q, k, v, causal=True, kv_len=kv_len)
        fwd_same_bits = torch.equal(out.view(torch.int16),
                                    out2.view(torch.int16)) and \
            torch.equal(lse, lse2)
        del again, out2, lse2
        log(json.dumps({"phase": "flash_err_over_tol",
                        "shape": [B, S, H, D, kv_len], **over,
                        "lse_max_abs_err": lse_err,
                        "fwd_same_bits_twice": fwd_same_bits,
                        "bwd_same_bits_twice": same_bits}))
        if max(over.values()) > 1.0 or lse_err > 1e-3:
            raise AssertionError(
                f"flash kernels disagree with their plain versions at "
                f"{(B, S, H, D, kv_len)}: worst |err| / tolerance {over}, "
                f"lse max |err| {lse_err} (tolerance 1e-3)")
        if not (same_bits and fwd_same_bits):
            raise AssertionError(
                f"flash kernels differ between two runs on the same "
                f"inputs at {(B, S, H, D, kv_len)}: forward same bits "
                f"{fwd_same_bits}, backward {same_bits}")

        delta = (do.float() * out.float()).sum(-1).transpose(1, 2) \
            .contiguous()
        tile = fa.flash_block_candidates(D, q.dtype)[0]    # the default
        t_fwd = event_ms(torch, lambda: ops.flash_fwd(q, k, v, True, klen,
                                                      *tile))
        t_dq = event_ms(torch, lambda: ops.flash_bwd_dq(
            q, k, v, do, lse, delta, True, klen, *fa.BWD_BLOCKS[0]))
        t_dkv = event_ms(torch, lambda: ops.flash_bwd_dkv(
            q, k, v, do, lse, delta, True, klen, *fa.BWD_BLOCKS[0]))
        p_fwd = event_ms(torch, lambda: fa.mha_fwd_ref(q, k, v, True,
                                                       kv_len), 3)
        p_bwd = event_ms(torch, lambda: fa.mha_bwd_ref(
            q, k, v, out, lse, do, True, kv_len), 3)
        # library yardstick: SDPA on [B, H, S, D] views, causal (with the
        # kv_len bound as an explicit boolean mask where there is one)
        lq, lk, lv = (t.detach().requires_grad_() for t in (q, k, v))
        qT, kT, vT = (t.transpose(1, 2) for t in (lq, lk, lv))
        if kv_len is None:
            def sdpa():
                return F.scaled_dot_product_attention(qT, kT, vT,
                                                      is_causal=True)
        else:
            pos = torch.arange(S, device=dev)
            mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] < kv_len)

            def sdpa():
                return F.scaled_dot_product_attention(qT, kT, vT,
                                                      attn_mask=mask)
        with torch.no_grad():
            l_fwd = event_ms(torch, sdpa)
        lo = sdpa()
        doT = do.transpose(1, 2)
        l_bwd = event_ms(torch, lambda: torch.autograd.grad(
            lo, (lq, lk, lv), doT, retain_graph=True))
        del lo

        pairs = B * H * live_pairs(S, kv_len)
        e = 2                                   # bf16 bytes
        q_bytes = B * S * H * D * e
        kv_bytes = B * min(S, klen) * H * D * e
        row_bytes = B * H * S * 4               # lse or delta, f32
        b_fwd = bound_ms(4 * pairs * D, q_bytes + 2 * kv_bytes + q_bytes
                         + row_bytes)
        b_dq = bound_ms(6 * pairs * D, 2 * q_bytes + 2 * kv_bytes
                        + 2 * row_bytes + q_bytes)
        b_dkv = bound_ms(8 * pairs * D, 2 * q_bytes + 2 * kv_bytes
                         + 2 * row_bytes + 2 * B * S * H * D * e)
        shape = {"B": B, "S": S, "H": H, "D": D, "kv_len": kv_len,
                 "causal": True, "dtype": "bfloat16"}
        rows = {
            "flash_fwd": dict(ms=t_fwd, plain_ms=p_fwd, library_ms=l_fwd,
                              bound=b_fwd, max_abs_err=errs["out"],
                              err_over_tol=over["out"],
                              lse_max_abs_err=lse_err,
                              design=ATTN_DESIGN["flash_fwd"]),
            "flash_bwd_dq": dict(ms=t_dq, plain_ms=p_bwd, library_ms=None,
                                 bound=b_dq, max_abs_err=errs["dq"],
                                 err_over_tol=over["dq"],
                                 design=ATTN_DESIGN["flash_bwd_dq"]),
            "flash_bwd_dkv": dict(ms=t_dkv, plain_ms=p_bwd,
                                  library_ms=None, bound=b_dkv,
                                  max_abs_err=max(errs["dk"],
                                                  errs["dv"]),
                                  err_over_tol=max(over["dk"],
                                                   over["dv"]),
                                  design=ATTN_DESIGN["flash_bwd_dkv"]),
        }
        for name, r in rows.items():
            r["bound_ms"], r["bound_by"] = r.pop("bound")
            line = {"phase": "kernel_check", "kernel": name, **shape, **r,
                    "roofline_share": r["bound_ms"] / r["ms"],
                    "tolerance": "per entry 2^-6*(|ref| + rms of its row "
                                 "over D) + 2^-10*rms(ref); lse 1e-3"}
            if name != "flash_fwd":
                line["plain_note"] = ("mha_bwd_ref computes dq, dk and dv "
                                      "together")
                line["library_bwd_pair_ms"] = l_bwd
                line["pair_ms"] = t_dq + t_dkv
                line["vs_library"] = (t_dq + t_dkv) / l_bwd
                line["bwd_same_bits_twice"] = same_bits
                line["library_note"] = (
                    "no library call computes this pass alone; "
                    "library_bwd_pair_ms is SDPA's whole backward "
                    "(dq, dk, dv), against the sum of the two kernels")
            else:
                line["library"] = "F.scaled_dot_product_attention forward"
                line["vs_library"] = t_fwd / l_fwd
                line["fwd_same_bits_twice"] = fwd_same_bits
            log(json.dumps(line))
        out_rows[(B, S, H, D, kv_len)] = rows
        del qkv, q, k, v, do, out, lse, grads, r_out, r_lse, r_grads
        del lq, lk, lv, qT, kT, vT, delta
    return out_rows


def attention_f64(torch, q, k, v, do):
    """Causal attention and its gradients in f64 from the same bf16
    inputs [B, S, H, D], one batch row at a time: (out, lse [B, H, S],
    dq, dk, dv)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    outs = []
    for b in range(q.shape[0]):
        qb, kb, vb, dob = (t[b].double().transpose(0, 1)
                           for t in (q, k, v, do))            # [H, S, D]
        S = qb.shape[1]
        s = (qb @ kb.transpose(-1, -2)) * scale
        s.masked_fill_(~q.new_ones(S, S, dtype=bool).tril(), -math.inf)
        lse = s.logsumexp(-1)
        p = (s - lse[..., None]).exp_()
        del s
        o = p @ vb
        ds = dob @ vb.transpose(-1, -2)
        ds.sub_((dob * o).sum(-1, keepdim=True)).mul_(p)
        outs.append((o, lse, ds @ kb * scale,
                     ds.transpose(-1, -2) @ qb * scale,
                     p.transpose(-1, -2) @ dob))
        del p, ds
    o, lse, dq, dk, dv = (torch.stack(t) for t in zip(*outs))
    return (o.transpose(1, 2), lse, dq.transpose(1, 2), dk.transpose(1, 2),
            dv.transpose(1, 2))


def attention_oracle(torch, dev):
    """Phase 2b's Llama shape against an f64 attention (ROADMAP C2): the
    largest and the rms |err| of the kernels and of the plain bf16
    versions, each from its own forward, against f64 from the same bf16
    inputs, forward and backward. A measurement line; the checks stay
    phase 2b's."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    B, S, H, D, _ = ATTN_LLAMA
    g = torch.Generator(device=dev).manual_seed(S + D)
    qkv = torch.randn(B, S, 3, H, D, generator=g,
                      device=dev).to(torch.bfloat16)
    q, k, v = qkv.unbind(2)
    do = torch.randn(B, S, H, D, generator=g, device=dev).to(torch.bfloat16)
    ref = attention_f64(torch, q, k, v, do)
    out, lse = fa.mha_fwd(q, k, v, causal=True)
    kern = (out, lse) + tuple(fa.mha_bwd(q, k, v, out, lse, do, causal=True))
    r_out, r_lse = fa.mha_fwd_ref(q, k, v, True, None)
    plain = (r_out, r_lse) + tuple(fa.mha_bwd_ref(q, k, v, r_out, r_lse, do,
                                                  True, None))
    line = {"phase": "flash_f64_oracle", "shape": [B, S, H, D],
            "causal": True, "dtype": "bfloat16"}
    for i, name in enumerate(("out", "lse", "dq", "dk", "dv")):
        line[name] = {"f64_rms": float(ref[i].square().mean().sqrt())}
        for who, got in (("kernel", kern[i]), ("plain", plain[i])):
            err = got.double() - ref[i]
            line[name][who + "_max_abs_err"] = float(err.abs().max())
            line[name][who + "_rms_err"] = float(err.square().mean().sqrt())
    log(json.dumps(line))
    del qkv, q, k, v, do, ref, out, lse, kern, r_out, r_lse, plain
    torch.cuda.empty_cache()
    return line


# the one-pass CE's checks: the GPT train step's logits, GPT-2's padded
# and raw vocabularies (50257: bf16 rows off 16 bytes), and Llama 3's
# vocabulary in f32, wider than one block's shared memory (a cluster of
# 3 blocks a row)
CE_SHAPES = [(8192, 32768, "bfloat16"), (8192, 50304, "bfloat16"),
             (8192, 50257, "bfloat16"), (2048, 128256, "float32")]
# the Llama step's logits, GPT-2's vocabulary, and the Llama step's
# logits on one rank of each of phase 6b's 3D plans (tp2's are the whole
# batch's; the pipelined step's vocab-parallel loss is stock torch and
# launches no CE kernel)
SHARDED_CE = {name: (sharded_rows(name) * LLAMA_SEQ, LLAMA["vocab_size"])
              for name in SHARDED_PLANS if plan_pp(name) == 1}
# and the GPT step's logits on the default CE route (phases 3b and 3c,
# every rank of 6b's GPT plans)
CE_PAIR_SHAPES = [(8192, 32000), (8192, 50257),
                  (TRAIN_BATCH * TRAIN_SEQ, FULL["vocab_size"])] + sorted(
    set(SHARDED_CE.values()) - {(8192, 32000)})


CE_DESIGN = ("persistent blocks of 512 threads walk the rows; each row "
             "comes into shared memory by one TMA bulk copy on an mbarrier "
             "(two row buffers where they fit), is reduced there (max, "
             "sum of exps) and dx leaves in 16-byte streaming stores; a "
             "row wider than a block's 227 KB is split over a cluster of "
             "2-4 blocks merged through distributed shared memory")


def ce_check(torch, dev):
    """Phase 2c, the one-pass CE, at each of CE_SHAPES with the plan it
    launches under. Returns {(T, V, dtype): row}."""
    import torch.nn.functional as F
    from paddle_tpu_torch.kernels import fused_ce as fce
    rows = {}
    for T, V, dtype in CE_SHAPES:
        g = torch.Generator(device=dev).manual_seed(V)
        x = (torch.randn(T, V, generator=g, device=dev) * 2).to(
            getattr(torch, dtype))
        t = torch.randint(0, V, (T,), generator=g, device=dev)
        loss, dx = fce.ce_fused(x, t)
        r_loss, r_dx = fce.ce_fused_ref(x, t)
        torch.cuda.synchronize()
        # tolerance: f32 sums of exps in another order (loss), and dx
        # rounded once to its dtype from f32 values ~1e-6 apart: one
        # bf16 step, or 1e-5 relative in f32 (the unit cotangent: every
        # |dx| entry is up to 1)
        step = 2.0 ** -7 if dtype == "bfloat16" else 1e-5
        loss_err = float((loss - r_loss).abs().max())
        err = (dx.float() - r_dx.float()).abs()
        dx_err = float(err.max())
        if loss_err > 1e-3 or not bool(
                (err <= step * r_dx.float().abs() + 1e-6).all()):
            raise AssertionError(
                f"fused_ce kernel disagrees with its plain version at "
                f"T={T} V={V} {dtype}: loss |err| {loss_err}, dx |err| "
                f"{dx_err} (step {step})")
        del r_loss, r_dx, err
        plan = fce._card_plan(T, V, x.dtype, x.device)
        t_k = event_ms(torch, lambda: fce.ce_fused(x, t))
        t_p = event_ms(torch, lambda: fce.ce_fused_ref(x, t), 3)
        xl = x.detach().requires_grad_()
        t_l = event_ms(torch, lambda: torch.autograd.grad(
            F.cross_entropy(xl, t, reduction="sum"), xl))
        b_ms, b_by = bound_ms(0, 2 * T * V * x.element_size() + T * 8
                              + T * 4)
        row = {"phase": "kernel_check", "kernel": "fused_ce", "T": T,
               "V": V, "dtype": dtype, "plan": plan, "ms": t_k,
               "plain_ms": t_p, "library_ms": t_l,
               "library": f"F.cross_entropy forward + backward ({dtype} "
                          "logits; a yardstick the port never calls)",
               "bound_ms": b_ms, "bound_by": b_by,
               "roofline_share": b_ms / t_k, "max_abs_err": max(loss_err,
                                                                dx_err),
               "loss_max_abs_err": loss_err, "dx_max_abs_err": dx_err,
               "dx_step": step,
               "tolerance": f"loss 1e-3; dx {step:g}*|ref| + 1e-6"}
        log(json.dumps(row))
        rows[(T, V, dtype)] = row
        del x, t, loss, dx, xl
    torch.cuda.empty_cache()
    return rows


def ce_pair_check(torch, dev):
    """Phase 2d, the two-pass CE. Returns {(T, V): {"ce_fwd": row,
    "ce_bwd": row}}."""
    import torch.nn.functional as F
    from paddle_tpu_torch.kernels import fused_ce as fce
    out = {}
    for T, V in CE_PAIR_SHAPES:
        gen = torch.Generator(device=dev).manual_seed(V)
        x = (torch.randn(T, V, generator=gen, device=dev) * 2).to(
            torch.bfloat16)
        t = torch.randint(0, V, (T,), generator=gen, device=dev)
        loss, lse = fce.ce_fwd(x, t)
        r_loss, r_lse = fce.ce_fwd_ref(x, t)
        torch.cuda.synchronize()
        # f32 sums of exps in another order
        loss_err = float((loss - r_loss).abs().max())
        lse_err = float((lse - r_lse).abs().max())
        if not loss_err <= 1e-3 or not lse_err <= 1e-3:
            raise AssertionError(
                f"ce_fwd kernel disagrees with its plain version at T={T} "
                f"V={V}: loss |err| {loss_err}, lse |err| {lse_err}")
        # both backward versions read the kernel's lse: the check is of
        # kernel 6 alone. dx within one bf16 step of the entry plus 1e-6
        # of the row's |g| (exps in another order): the bound scales
        # with g, so it means as much at g = 1/T (every entry ~1e-9) as
        # at g = 1
        dx_err, dx_over = {}, {}
        for label, gval in (("mean", 1.0 / T), ("one", 1.0)):
            g = torch.full((T,), gval, device=dev)
            dx = fce.ce_bwd(x, t, lse, g)
            r_dx = fce.ce_bwd_ref(x, t, lse, g)
            torch.cuda.synchronize()
            err = (dx.float() - r_dx.float()).abs()
            tol = 2.0 ** -7 * r_dx.float().abs() + 1e-6 * gval
            dx_err[label] = float(err.max())
            dx_over[label] = float((err / tol).max())
            if not dx_over[label] <= 1.0 or not bool(
                    torch.isfinite(dx).all()):
                raise AssertionError(
                    f"ce_bwd kernel disagrees with its plain version at "
                    f"T={T} V={V} g={gval}: max |err| {dx_err[label]}, "
                    f"worst err/tol {dx_over[label]}")
            del dx, r_dx, err, tol
        g = torch.full((T,), 1.0 / T, device=dev)
        t_fwd = event_ms(torch, lambda: fce.ce_fwd(x, t))
        t_bwd = event_ms(torch, lambda: fce.ce_bwd(x, t, lse, g))
        p_fwd = event_ms(torch, lambda: fce.ce_fwd_ref(x, t), 3)
        p_bwd = event_ms(torch, lambda: fce.ce_bwd_ref(x, t, lse, g), 3)
        with torch.no_grad():
            l_fwd = event_ms(torch, lambda: F.cross_entropy(
                x, t, reduction="none"))
        xl = x.detach().requires_grad_()
        lo = F.cross_entropy(xl, t, reduction="none")
        l_bwd = event_ms(torch, lambda: torch.autograd.grad(
            lo, xl, g, retain_graph=True))
        del lo, xl
        rows_b = T * 8 + 2 * T * 4          # targets in; loss+lse or lse+g
        shape = {"T": T, "V": V, "dtype": "bfloat16"}
        rows = {
            "ce_fwd": dict(ms=t_fwd, plain_ms=p_fwd, library_ms=l_fwd,
                           bound=bound_ms(0, T * V * 2 + rows_b),
                           max_abs_err=max(loss_err, lse_err),
                           loss_max_abs_err=loss_err,
                           lse_max_abs_err=lse_err,
                           library="F.cross_entropy(reduction='none') "
                                   "forward",
                           tolerance="loss and lse 1e-3"),
            "ce_bwd": dict(ms=t_bwd, plain_ms=p_bwd, library_ms=l_bwd,
                           bound=bound_ms(0, 2 * T * V * 2 + rows_b),
                           max_abs_err=max(dx_err.values()),
                           dx_max_abs_err=dx_err, dx_err_over_tol=dx_over,
                           library="backward of F.cross_entropy("
                                   "reduction='none') at g = 1/T, the "
                                   "forward outside the timed window",
                           tolerance="dx 2^-7*|ref| + 1e-6*|g|, at "
                                     "g = 1/T and g = 1"),
        }
        for name, r in rows.items():
            r["bound_ms"], r["bound_by"] = r.pop("bound")
            log(json.dumps({"phase": "kernel_check", "kernel": name,
                            **shape, **r,
                            "roofline_share": r["bound_ms"] / r["ms"]}))
        out[(T, V)] = rows
        del x, t, loss, lse, r_loss, r_lse, g
    return out


def shard_shapes(name):
    """{leaf: the shape of a rank's shard} of the TinyLlama-width tree at
    SHARDED_LAYERS under phase 6b's plan `name`: each dim divided by the
    sizes of the mesh axes models/llama.py's PARAM_SPECS names for it,
    where they divide it (parallel/mesh.py's rule). 6b holds every
    rank's shards to it."""
    from paddle_tpu_torch.models.llama import PARAM_SPECS
    axes = SHARDED_PLANS[name]
    sizes = {"dp": axes["dp"], "fsdp": axes["fsdp"], "mp": axes["tp"],
             "pp": plan_pp(name)}
    out = {}
    for leaf, shape in llama_leaves(SHARDED_LAYERS).items():
        local = list(shape)
        for d, entry in enumerate(PARAM_SPECS[leaf]):
            names = entry if isinstance(entry, tuple) else (entry,)
            n = math.prod(sizes.get(a, 1) for a in names if a)
            if local[d] % n == 0:
                local[d] //= n
        out[leaf] = tuple(local)
    return out


def sharded_launches(name, per_step):
    """{kernel: launches a step a rank} under phase 6b's plan `name`:
    `per_step`, the unsharded step's at SHARDED_LAYERS, for a 3D plan
    (every rank runs every layer on its rows). Under
    pp a rank runs its stage's L/pp layers on each of its m
    microbatches, the flash forward twice (full remat recomputes it),
    the backward pair once; no CE kernel (the vocab-parallel loss is
    stock torch); the update once over all its leaves (every stage
    holds wte, norm_f and its chunk of each stacked leaf)."""
    if plan_pp(name) == 1:
        return dict(per_step)
    calls = SHARDED_LAYERS // plan_pp(name) * \
        SHARDED_PLANS[name]["microbatches"]
    out = {k: 0 for k in per_step}
    out.update(flash_fwd=2 * calls, flash_bwd_dq=calls, flash_bwd_dkv=calls,
               leaf_update=1, leaf_update_leaves=len(shard_shapes(name)))
    return out


def shard_state_bytes(name):
    """Bytes of a rank's params and both AdamW moments under plan
    `name`: three f32 copies of its shards (shard_shapes)."""
    return 3 * 4 * sum(math.prod(s) for s in shard_shapes(name).values())


UPDATE_DESIGN = ("one launch over a by-value table of up to 80 leaves; a "
                 "persistent grid whose blocks walk 4096-element chunks, "
                 "finding a chunk's leaf by binary search; 4 16-byte "
                 "vectors of each operand in flight a thread, plain "
                 "loads and stores")


def update_rows(torch, dev, shapes, hp, step, tag=""):
    """The AdamW update kernel against its plain version at each of
    `shapes` ({leaf: shape}, f32): each leaf alone (a table of one),
    timed beside its plain version and torch._fused_adamw_, then one
    train step's update as it runs, one leaves_update over all of them
    (one launch), timed beside the plain version over every leaf and one
    torch._fused_adamw_ call over all of them. Returns {leaf: row} and
    that "step" row."""
    from paddle_tpu_torch.kernels import fused_update as fu
    gen = torch.Generator(device=dev).manual_seed(7)
    leaves, rows = {}, {}
    for name, shape in shapes.items():
        p = torch.randn(shape, generator=gen, device=dev) * 0.02
        g = torch.randn(shape, generator=gen, device=dev) * 1e-3
        m = torch.randn(shape, generator=gen, device=dev) * 1e-4
        v = torch.rand(shape, generator=gen, device=dev) * 1e-7
        ref = fu.leaf_update_ref(p, g, m, v, hp)
        fu.leaf_update(p, g, m, v, hp)
        torch.cuda.synchronize()
        # both round every operation on its own in one order, and the
        # card divides and takes square roots correctly rounded: 0 ulps
        # expected, 1 ulp allowed
        errs = [float((got - want).abs().max())
                for got, want in zip((p, m, v), ref)]
        ok = all(bool(((got - want).abs()
                       <= 2.0 ** -23 * want.abs()).all())
                 for got, want in zip((p, m, v), ref))
        if not ok:
            raise AssertionError(f"leaf_update kernel disagrees with its "
                                 f"plain version at {tag}{name} {shape}: "
                                 f"max |err| p/m/v {errs}")
        del ref
        n = p.numel()
        t_k = event_ms(torch, lambda: fu.leaf_update(p, g, m, v, hp))
        t_p = event_ms(torch, lambda: fu.leaf_update_ref(p, g, m, v, hp), 3)
        t_l = event_ms(torch, lambda: torch._fused_adamw_(
            [p], [g], [m], [v], [], [step], lr=ADAMW["lr"],
            beta1=ADAMW["beta1"], beta2=ADAMW["beta2"],
            weight_decay=ADAMW["weight_decay"], eps=ADAMW["eps"],
            amsgrad=False, maximize=False))
        b_ms, b_by = bound_ms(10 * n, 28 * n)
        rows[name] = {"phase": "kernel_check", "kernel": "leaf_update",
                      "leaf": tag + name, "shape": list(shape), "n": n,
                      "dtype": "float32", "ms": t_k, "plain_ms": t_p,
                      "library_ms": t_l, "bound_ms": b_ms, "bound_by": b_by,
                      "roofline_share": b_ms / t_k,
                      "max_abs_err": max(errs),
                      "p_m_v_max_abs_err": errs,
                      "tolerance": "p, m, v within 1 f32 ulp (0 expected)"}
        log(json.dumps(rows[name]))
        leaves[name] = (p, g, m, v)
    # one step's update as it runs: one leaves_update over every leaf (one
    # launch for the f32 tree), held to the plain version leaf by leaf
    n_all = sum(p.numel() for p, _, _, _ in leaves.values())
    ps, gs, ms, vs = (list(x) for x in zip(*leaves.values()))
    want = [fu.leaf_update_ref(*ops, hp) for ops in leaves.values()]
    before = dict(fu.launches)
    fu.leaves_update(ps, gs, ms, vs, hp)
    torch.cuda.synchronize()
    got = {k: fu.launches[k] - before[k] for k in before}
    if got != {"leaf_update": 1, "leaf_update_leaves": len(leaves)}:
        raise AssertionError(f"leaves_update over {tag}all {len(leaves)}: "
                             f"launches {got}")
    errs = [max(float((a - b).abs().max()) for a, b in zip((p, m, v), ref))
            for (p, _, m, v), ref in zip(leaves.values(), want)]
    if not all(bool(((a - b).abs() <= 2.0 ** -23 * b.abs()).all())
               for (p, _, m, v), ref in zip(leaves.values(), want)
               for a, b in zip((p, m, v), ref)):
        raise AssertionError(f"leaves_update disagrees with its plain "
                             f"version over {tag}all {len(leaves)}: max "
                             f"|err| by leaf {errs}")
    del want
    t_k = event_ms(torch, lambda: fu.leaves_update(ps, gs, ms, vs, hp))
    t_p = event_ms(torch, lambda: [fu.leaf_update_ref(*ops, hp)
                                   for ops in leaves.values()], 3)
    t_lib = event_ms(torch, lambda: torch._fused_adamw_(
        ps, gs, ms, vs, [], [step] * len(leaves), lr=ADAMW["lr"],
        beta1=ADAMW["beta1"], beta2=ADAMW["beta2"],
        weight_decay=ADAMW["weight_decay"], eps=ADAMW["eps"],
        amsgrad=False, maximize=False))
    b_ms, b_by = bound_ms(10 * n_all, 28 * n_all)
    rows["step"] = {
        "phase": "kernel_check", "kernel": "leaf_update",
        "leaf": f"{tag}all {len(leaves)}", "n": n_all, "launches": 1,
        "ms": t_k, "plain_ms": t_p, "library_ms": t_lib,
        "sum_of_leaf_ms": sum(r["ms"] for r in rows.values()),
        "library": f"one torch._fused_adamw_ call over the {len(leaves)} "
                   "leaves (the function behind "
                   "torch.optim.AdamW(fused=True))",
        "bound_ms": b_ms, "bound_by": b_by, "roofline_share": b_ms / t_k,
        "max_abs_err": max(errs + [r["max_abs_err"]
                                   for r in rows.values()]),
        "tolerance": "p, m, v within 1 f32 ulp (0 expected)"}
    log(json.dumps(rows["step"]))
    del leaves, ps, gs, ms, vs
    torch.cuda.empty_cache()
    return rows


def update_check(torch, dev):
    """Phase 2e, the AdamW leaf update, f32, at every leaf shape of the
    TinyLlama-width tree, at every shard shape of it under phase 6b's
    plans, and at every leaf shape of the GPT trees the update runs on:
    phase 3c's MoE tree and a rank's shards under 6b's GPT plans (the
    dense tree once for both sp2 plans, which replicate it). Returns
    {leaf: row}, a "step" row (one train step's update), {"sharded":
    {plan: its step row}} and {"gpt": {tree: its step row}}."""
    step = torch.full((), 3.0, device=dev)
    hp = torch.stack([torch.full((), ADAMW[k], device=dev) for k in
                      ("lr", "beta1", "beta2", "eps", "weight_decay")]
                     + [1.0 - ADAMW["beta1"] ** step,
                        1.0 - ADAMW["beta2"] ** step])
    rows = update_rows(torch, dev, LLAMA_LEAVES, hp, step)
    rows["sharded"] = {
        name: update_rows(torch, dev, shard_shapes(name), hp, step,
                          tag=f"{name}:")["step"]
        for name in SHARDED_PLANS}
    trees = {"gpt_moe": GPT_MOE_LEAVES}
    for name in GPT_PLANS:
        shapes = gpt_plan_shapes(name)
        same = [k for k, v in trees.items() if v == shapes]
        if same:
            trees[f"{same[0]}+{name}"] = trees.pop(same[0])
        else:
            trees[f"gpt_{name}"] = shapes
    rows["gpt"] = {tree: update_rows(torch, dev, shapes, hp, step,
                                     tag=f"{tree}:")["step"]
                   for tree, shapes in trees.items()}
    return rows


# the serving phases with sampled requests, each of which must launch the
# threefry kernel
SAMPLING_PHASES = ("gpt_serving", "gpt_serving_chaos", "gpt_fleet",
                   "llama_serving", "llama_paged", "llama_multi_tick",
                   "llama_tp2", "llama_tp2_spec", "llama_tp2_preempt")
# the serving sampler's draws: [slots, V] at the GPT and the Llama vocab
THREEFRY_SHAPES = [(8, FULL["vocab_size"]), (8, LLAMA["vocab_size"])]
# 32-bit integer operations a second: the data sheet's f32 rate (67
# TFLOP/s: an FMA as 2 on 128 lanes an SM) over 2 for one operation an
# instruction and over 2 for the 64 integer lanes an SM
PEAK_INT32_OPS = 67e12 / 4
# 32-bit integer operations of one Threefry-2x32 hash, counting each as
# one sm_90 instruction: the key parity k1 ^ k2 ^ 0x1BD11BDA (one
# three-input LOP3), the two counter adds, 20 rounds of add, rotate (one
# funnel shift, SHF.L.W) and xor, 10 key injections (the second word's
# a three-input IADD3 with the group's count) and the output xor
THREEFRY_HASH_OPS = 1 + 2 + 20 * 3 + 10 + 1
# a draw: per element a hash under the row's key, its parity taken once
# a row; per row the two fold_ins that make the slot's key
THREEFRY_OPS_ELEMENT = THREEFRY_HASH_OPS - 1
THREEFRY_OPS_ROW = 2 * THREEFRY_HASH_OPS + 1
THREEFRY_DESIGN = ("a row a block row; each thread folds its row's key in "
                   "once, then hashes 8 columns, the 20 rounds unrolled on "
                   "32-bit words")


def threefry_check(torch, dev):
    """Phase 2f, the threefry bits kernel (kernels/threefry.py) against
    its plain int64 version at the sampler's draws (THREEFRY_SHAPES) as
    `_sample` makes them: the engine's seed 0 and each slot's (request
    id, token index) folded in by the draw, the same bits twice; the
    same draw under the slot keys given whole (`_slot_keys`, the form
    with no fold) equal too. Timed beside the plain version. No PyTorch
    call computes these bits (torch's generators are Philox). Returns
    {(rows, n): row}."""
    from paddle_tpu_torch.inference import prng
    from paddle_tpu_torch.inference import serving as srv
    from paddle_tpu_torch.kernels import threefry as tf
    out = {}
    for rows, n in THREEFRY_SHAPES:
        rid = torch.arange(rows, dtype=torch.int32, device=dev) * 3 + 1
        gi = torch.arange(rows, dtype=torch.int32, device=dev) + 7
        s1, s2 = prng.prng_key(0)
        k1, k2 = srv._slot_keys(0, rid, gi)
        got = tf.bits(s1, s2, n, (rid, gi))
        again = tf.bits(s1, s2, n, (rid, gi))
        whole = tf.bits(k1, k2, n)
        want = tf.bits_ref(s1, s2, n, (rid, gi))
        torch.cuda.synchronize()
        if not (torch.equal(got, want) and torch.equal(got, again)
                and torch.equal(whole, want)):
            bad = int((got != want).sum()) + int((whole != want).sum())
            raise AssertionError(f"threefry bits kernel disagrees with its "
                                 f"plain version at [{rows}, {n}]: {bad} "
                                 "words differ")
        t_k = event_ms(torch, lambda: tf.bits(s1, s2, n, (rid, gi)))
        t_p = event_ms(torch, lambda: tf.bits_ref(s1, s2, n, (rid, gi)), 3)
        ops = THREEFRY_OPS_ELEMENT * rows * n + THREEFRY_OPS_ROW * rows
        nbytes = 8 * rows * n + 8 * rows
        t_ops, t_bytes = ops / PEAK_INT32_OPS, nbytes / PEAK_BYTES
        b_ms = max(t_ops, t_bytes) * 1e3
        row = {"phase": "kernel_check", "kernel": "threefry_bits",
               "shape": [rows, n], "ms": t_k, "plain_ms": t_p,
               "library_ms": None, "bound_ms": b_ms,
               "bound_by": "operations" if t_ops > t_bytes else "bytes",
               "roofline_share": b_ms / t_k, "max_abs_err": 0.0,
               "same_bits_twice": True, "design": THREEFRY_DESIGN,
               "tolerance": "every word equal"}
        log(json.dumps(row))
        out[(rows, n)] = row
        del got, again, whole, want
    return out


def _cos(a, b):
    a, b = a.double().flatten(), b.double().flatten()
    den = float(a.norm() * b.norm())
    return float(a @ b) / den if den > 0 else (1.0 if float(
        (a - b).abs().max()) == 0 else 0.0)


@contextlib.contextmanager
def forced_registry(**table):
    """Force the port registry's answers for the named kernels, through
    the `registry.winner` seam every consult site reads, as the
    reference's tools/ablate_step.py forces its own; restored after."""
    from paddle_tpu_torch.kernels import registry
    orig = registry.winner

    def winner(kernel, backend=None, bucket="*", path=None):
        return table.get(kernel) or orig(kernel, backend=backend,
                                         bucket=bucket, path=path)
    registry.winner = winner
    try:
        yield
    finally:
        registry.winner = orig


@contextlib.contextmanager
def plain_versions():
    """The train steps on the kernels' plain versions: rebinds the
    attention and loss that models/gpt.py and models/llama.py look up at
    each call to partials over mha_fwd_ref / mha_bwd_ref and ce_fwd_ref /
    ce_bwd_ref / ce_fused_ref, and forces the plain per-leaf AdamW;
    restores them after."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import fused_ce as fce
    from paddle_tpu_torch.models import gpt, llama
    saved = [(mod, mod.flash_attention_fn, mod.fused_softmax_ce)
             for mod in (gpt, llama)]
    for mod, attn, ce in saved:
        mod.flash_attention_fn = functools.partial(
            attn, fwd=fa.mha_fwd_ref, bwd=fa.mha_bwd_ref)
        mod.fused_softmax_ce = functools.partial(
            ce, fwd=fce.ce_fwd_ref, bwd=fce.ce_bwd_ref,
            fused=fce.ce_fused_ref)
    try:
        with forced_registry(fused_update="jax"):
            yield
    finally:
        for mod, attn, ce in saved:
            mod.flash_attention_fn, mod.fused_softmax_ce = attn, ce


@contextlib.contextmanager
def plain_attention_block(block):
    """The plain attention with kv blocks of `block`: the same function,
    summed in another order."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    saved, fa._BLOCK_KV = fa._BLOCK_KV, block
    try:
        yield
    finally:
        fa._BLOCK_KV = saved


def train_profile(torch, step, params, opt, tokens, card, label,
                  n_steps=1):
    """Where a train step's time goes: n_steps under torch.profiler.
    Prints the device busy share of the window and the device time by
    kernel name (top 12)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            step(params, opt, tokens)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    rows = [(dev_us(e), e.count, e.key) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    log(json.dumps({
        "phase": f"{label}_profile", "card": card, "steps": n_steps,
        "wall_ms": wall_ms,
        "device_busy_ms": busy_ms if rows else "not measured",
        "device_busy_share": busy_ms / wall_ms if rows else "not measured",
        "top_kernels": [{"name": k[:90], "device_ms": us / 1e3,
                         "calls": n} for us, n, k in rows[:12]]}))


def launch_counts():
    """Every kernel counter of the train steps, by kernel name."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import fused_ce as fce
    from paddle_tpu_torch.kernels import fused_update as fu
    return dict(fa.launches, **fce.launches, **fu.launches)


@contextlib.contextmanager
def kernel_shapes():
    """The shapes the flash and CE kernels launch at inside the body:
    {kernel: sorted [shape]}, flash (B, S, H, D), CE (T, V), taken
    where each launch is made and counted."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import fused_ce as fce
    seen = {}
    call, launch = fa._call, fce._launch

    def flash_call(kernel, dtype, ptrs, dims, *args, **kw):
        B, H, Sq, _, D = dims[:5]
        seen.setdefault(kernel, set()).add((B, Sq, H, D))
        return call(kernel, dtype, ptrs, dims, *args, **kw)

    def ce_launch(kernel, dtype, args, T, V, device, **kw):
        seen.setdefault(kernel, set()).add((T, V))
        return launch(kernel, dtype, args, T, V, device, **kw)
    out = {}
    fa._call, fce._launch = flash_call, ce_launch
    try:
        yield out
    finally:
        fa._call, fce._launch = call, launch
        out.update({k: sorted(list(sh) for sh in v) for k, v in seen.items()})


def zero_launch_counts():
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import fused_ce as fce
    from paddle_tpu_torch.kernels import fused_update as fu
    for counts in (fa.launches, fce.launches, fu.launches):
        for name in counts:
            counts[name] = 0


def train_tokens(torch, dev, cfg, batch, seq, seed):
    return torch.as_tensor(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(batch, seq + 1)), device=dev)


def host_state(params, opt):
    """A copy of (params, opt) on the host, so it takes no device memory,
    and the function that copies it back in place."""
    def host(t):
        return t.to("cpu", copy=True)
    state0 = ({k: host(v) for k, v in params.items()},
              {k: ({n: host(t) for n, t in v.items()}
                   if isinstance(v, dict) else host(v))
               for k, v in opt.items()})

    def restore():
        for k, v in state0[0].items():
            params[k].copy_(v)
        for k, v in state0[1].items():
            if isinstance(v, dict):
                for n, t in v.items():
                    opt[k][n].copy_(t)
            else:
                opt[k].copy_(v)
    return restore


# the plain versions' trajectory of phases 3 and 4: the kernels' first
# steps against it (the kernels run 5)
PLAIN_STEPS = 3


def train_phase(torch, dev, card, label, mod, cfg, params, batch, seq,
                seed, per_step):
    """One family's train step at full width (phases 3 and 4): step 1
    against the plain versions, a 5-step trajectory on the kernels held
    to PLAIN_STEPS on the plain versions, 10 timed steps with
    the launches per step asserted equal to `per_step`, a profile.
    `mod` is models.gpt or models.llama. Returns (launches over the 10
    timed steps, the "train" line, the tokens, the kernels' 5-step
    trajectory)."""
    from paddle_tpu_torch.models.gpt import init_opt_state
    opt = init_opt_state(params)
    tokens = train_tokens(torch, dev, cfg, batch, seq, seed)
    restore = host_state(params, opt)

    # step 1's gradients on the kernels and on their plain versions; and,
    # for the noise floor of bf16 training, the plain versions against
    # themselves with only the plain attention's kv blocks changed (256
    # instead of 512; and 64, the bf16 kernels' kv tile, so that p is
    # rounded to bf16 against running maxima as fine as the kernels')
    k_loss, k_grads = mod.loss_and_grads(params, tokens, cfg)
    with plain_versions():
        p_loss, p_grads = mod.loss_and_grads(params, tokens, cfg)
        cos = {n: _cos(k_grads[n], p_grads[n]) for n in k_grads}
        del k_grads
        floors = {}
        for block in (256, 64):
            with plain_attention_block(block):
                _, q_grads = mod.loss_and_grads(params, tokens, cfg)
            floors[block] = {n: _cos(q_grads[n], p_grads[n])
                             for n in p_grads}
            del q_grads
    floor, floor64 = floors[256], floors[64]
    del p_grads
    k_loss, p_loss = float(k_loss), float(p_loss)
    log(json.dumps({"phase": f"{label}_grads_kernel_vs_plain",
                    "loss_kernel": k_loss, "loss_plain": p_loss,
                    "loss_rel_diff": abs(k_loss - p_loss) / abs(p_loss),
                    "min_cosine": min(cos.values()),
                    "cosine_by_leaf": cos,
                    "plain_vs_plain_block256_min_cosine":
                        min(floor.values()),
                    "plain_vs_plain_block256_cosine_by_leaf": floor,
                    "plain_vs_plain_block64_cosine_by_leaf": floor64,
                    # per leaf: the kernel's cosine beside the two floors,
                    # and the leaves where the kernel falls below each
                    "kernel_floor256_floor64_by_leaf": {
                        n: [cos[n], floor[n], floor64[n]] for n in cos},
                    "leaves_below_floor": sorted(
                        n for n in cos if cos[n] < floor[n]),
                    "leaves_below_block64_floor": sorted(
                        n for n in cos if cos[n] < floor64[n])}))
    if not math.isfinite(k_loss) or abs(k_loss - p_loss) > 2e-3 * abs(
            p_loss):
        raise AssertionError(f"{label} step-1 loss: kernel {k_loss} vs "
                             f"plain {p_loss} (tolerance 2e-3 relative)")
    bad = {n: c for n, c in cos.items() if not c >= 0.999}
    if bad:
        raise AssertionError(f"{label} step-1 gradient cosine < 0.999: "
                             f"{bad}")

    # 5 steps from the same state on the kernels (6a holds its trajectory
    # to them), then PLAIN_STEPS on the plain versions, held to the
    # kernels' first PLAIN_STEPS
    traj = {}
    for name, ctx, n in (("kernel", contextlib.nullcontext, 5),
                         ("plain", plain_versions, PLAIN_STEPS)):
        restore()
        with ctx():
            traj[name] = [float(mod.train_step(params, opt, tokens, cfg,
                                               **ADAMW)[0])
                          for _ in range(n)]
    rel = [abs(a - b) / abs(b) for a, b in zip(traj["kernel"],
                                               traj["plain"])]
    log(json.dumps({"phase": f"{label}_trajectory",
                    "kernel": traj["kernel"], "plain": traj["plain"],
                    "rel_diff": rel}))
    if abs(traj["kernel"][0] - k_loss) > 1e-6 * abs(k_loss) + 1e-6 or \
            max(rel) > 1e-2:
        raise AssertionError(f"{label} trajectories differ: {traj}")
    restore()
    del restore
    torch.cuda.empty_cache()

    launches, line, step = timed_steps(torch, card, label, mod, cfg, params,
                                       opt, tokens, per_step)
    train_profile(torch, step, params, opt, tokens, card, label)
    return launches, line, tokens, traj["kernel"]


def timed_steps(torch, card, label, mod, cfg, params, opt, tokens, per_step,
                flops_params=None, **extra):
    """2 warm-up and 10 timed steps through make_train_step, the counts
    set to 0 just before the timed steps and read just after, asserted
    equal to 10 x `per_step`; prints the line (step ms p50/p90,
    tokens/s, MFU, peak memory, the warm-up losses, `extra`). MFU counts
    `flops_params` parameters (default: every parameter). Returns
    (launches over the 10 steps, the line, the step function)."""
    from paddle_tpu_torch.cost_model import train_flops_per_token
    from paddle_tpu_torch.models.facade import make_train_step
    batch, seq = tokens.shape[0], tokens.shape[1] - 1
    n_params = sum(p.numel() for p in params.values())
    if flops_params is None:
        flops_params = n_params
    step = make_train_step(mod.train_step, cfg=cfg, **ADAMW)
    warm = [float(step(params, opt, tokens)[0]) for _ in range(2)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launch_counts()                          # the main path starts
    step_ms, losses = [], []
    for _ in range(10):
        t_s = time.perf_counter()
        loss, _, _ = step(params, opt, tokens)
        losses.append(float(loss))                # waits for the step
        step_ms.append((time.perf_counter() - t_s) * 1e3)
    launches = launch_counts()                    # ... and ends
    want = {k: 10 * per_step.get(k, 0) for k in launches}
    if launches != want:
        raise AssertionError(f"{label}: launches over 10 steps {launches} "
                             f"!= {want}")
    if not all(math.isfinite(x) for x in warm + losses):
        raise AssertionError(f"{label}: non-finite losses {warm + losses}")
    p50 = statistics.median(step_ms)
    tok_s = batch * seq / (p50 / 1e3)
    fpt = train_flops_per_token(flops_params, cfg.num_layers,
                                cfg.hidden_size, seq)
    line = {
        "phase": label, "card": card, "params": n_params,
        "flops_params": flops_params, "batch": batch,
        "seq": seq, "remat": cfg.remat,
        "remat_policy": getattr(cfg, "remat_policy", "full"), **extra,
        "steps": 10, "step_ms": step_ms, "step_ms_p50": p50,
        "step_ms_p90": float(np.percentile(step_ms, 90)),
        "tokens_per_s": tok_s, "flops_per_token": fpt,
        "mfu": fpt * tok_s / PEAK_BF16_FLOPS,
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "warmup_losses": warm, "losses": losses, "launches": launches,
        "launches_per_step": {k: v // 10 for k, v in launches.items()}}
    log(json.dumps(line))
    return launches, line, step


def training(torch, dev, card):
    """Phase 3, GPT, with the one-pass CE forced. Returns the launches
    over the 10 timed steps."""
    from paddle_tpu_torch.models import gpt
    cfg = gpt.GPTConfig(**FULL, remat=True, remat_policy="dots")
    L = cfg.num_layers
    t0 = time.perf_counter()
    params = gpt.init_gpt_params(cfg, seed=0)
    log(f"gpt_train: params built in {time.perf_counter() - t0:.1f} s")
    with forced_registry(ce="pallas_fused"):
        launches, _, _, _ = train_phase(
            torch, dev, card, "gpt_train", gpt, cfg, params, TRAIN_BATCH,
            TRAIN_SEQ, 2, {"flash_fwd": 2 * L, "flash_bwd_dq": L,
                           "flash_bwd_dkv": L, "fused_ce": 1})
    del params
    torch.cuda.empty_cache()
    return launches


# phase 3b: the port's counterpart of bench.py's tpu-rung variant race
# (bench.py:299-320) with the attention impl fixed to "pallas":
# (name, remat, remat_policy, batch)
RACE = [("dots", True, "dots", 8), ("full", True, "full", 8),
        ("dots_flash", True, "dots_flash", 8),
        ("offload_dots", True, "offload_dots", 8),
        ("all_but_mlp", True, "all_but_mlp", 8),
        ("all_but_mlp_b12", True, "all_but_mlp", 12),
        ("no_remat_b4", False, "full", 4), ("dots_b16", True, "dots", 16)]
# policies whose backward reruns no attention forward
ONE_FWD = ("dots_flash", "all_but_mlp")
ROUTE_LAYERS = 4
# the race's depth: a twelfth of the headline's 24 layers at its widths,
# so that phases 3c, 5f and 6, 6a's telemetry, Profiler window and
# out-of-memory check included, fit the script's time limit (PERF.md)
RACE_LAYERS = 2
# (name, env) of the route steps, each set for its own step only
ROUTES = [("default", {}), ("xla", {"PADDLE_TPU_ATTN_IMPL": "xla"}),
          ("attn_kill", {"PADDLE_TPU_DISABLE_PALLAS_ATTN": "1"}),
          ("bwd_kill", {"PADDLE_TPU_DISABLE_PALLAS_BWD": "1"}),
          ("global_kill", {"PADDLE_TPU_DISABLE_PALLAS": "1"}),
          ("splash", {"PADDLE_TPU_ATTN_IMPL": "splash"}),
          ("jax_flash", {"PADDLE_TPU_ATTN_IMPL": "jax_flash"}),
          ("default_again", {})]


@contextlib.contextmanager
def env_set(**env):
    """Set environment variables for the body; restored after."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def step_launches(L, remat, policy, attn=True, bwd=True, ce=True):
    """Kernel launches of one GPT step on the default CE route."""
    fwd = L if not remat or policy in ONE_FWD else 2 * L
    return {"flash_fwd": fwd if attn else 0,
            "flash_bwd_dq": L if attn and bwd else 0,
            "flash_bwd_dkv": L if attn and bwd else 0,
            "ce_fwd": 1 if ce else 0, "ce_bwd": 1 if ce else 0}


def race(torch, dev, card):
    """Phase 3b: the GPT step at the headline widths, RACE_LAYERS deep,
    under each variant of RACE (2 warm-up and 10 timed steps each, from
    one starting state
    and seed-2 tokens, the CE and the update on their default routes),
    each variant's flash launches asserted and its first loss at batch 8
    held to "dots"'s within phase 3's tolerance across runs; a variant
    that runs out of device memory is printed as OOM and the race goes
    on. Then one step at ROUTE_LAYERS layers under each of ROUTES.
    Returns the launches over every timed and route step."""
    import dataclasses
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.models.losses import ce_route
    from paddle_tpu_torch.models.remat import HOST_POOL
    base = gpt.GPTConfig(**dict(FULL, num_layers=RACE_LAYERS))
    L = base.num_layers
    params = gpt.init_gpt_params(base, seed=0)
    opt = gpt.init_opt_state(params)
    restore = host_state(params, opt)
    total = {}
    results, first = {}, {}
    for name, remat, policy, batch in RACE:
        cfg = dataclasses.replace(base, remat=remat, remat_policy=policy)
        restore()
        HOST_POOL.clear()
        tokens = train_tokens(torch, dev, cfg, batch, TRAIN_SEQ, 2)
        oom = None
        try:
            launches, line, step = timed_steps(
                torch, card, "gpt_race", gpt, cfg, params, opt, tokens,
                step_launches(L, remat, policy), variant=name)
        except torch.cuda.OutOfMemoryError as e:
            oom = str(e)[:200]
        if oom is not None:
            # freed outside the handler, whose traceback holds the step
            log(json.dumps({"phase": "gpt_race", "card": card,
                            "variant": name, "batch": batch, "oom": True,
                            "error": oom}))
            del tokens
            gc.collect()
            torch.cuda.empty_cache()
            continue
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        line = {"variant": name, "pinned_host_bytes":
                HOST_POOL.pinned_bytes, **line}
        train_profile(torch, step, params, opt, tokens, card,
                      f"gpt_race_{name}", n_steps=1)
        results[name] = line
        if batch == TRAIN_BATCH:
            first[name] = line["warmup_losses"][0]
        log(json.dumps({"phase": "gpt_race_variant", "variant": name,
                        "batch": batch, "step_ms_p50": line["step_ms_p50"],
                        "step_ms_p90": line["step_ms_p90"],
                        "tokens_per_s": line["tokens_per_s"],
                        "mfu": line["mfu"],
                        "peak_bytes": line["max_memory_allocated_bytes"],
                        "pinned_host_bytes": line["pinned_host_bytes"],
                        "flash_per_step": {
                            k: line["launches_per_step"][k]
                            for k in ("flash_fwd", "flash_bwd_dq",
                                      "flash_bwd_dkv")},
                        "first_loss": line["warmup_losses"][0]}))
        del tokens, step
        HOST_POOL.clear()
        torch.cuda.empty_cache()
    ref = first.get("dots")
    off = {n: x for n, x in first.items()
           if ref is None or abs(x - ref) > 1e-6 * abs(ref) + 1e-6}
    if ref is None or off:
        raise AssertionError(f"gpt_race: first losses at batch "
                             f"{TRAIN_BATCH} {first} differ from dots's "
                             f"{ref}")
    best = max(results, key=lambda n: results[n]["tokens_per_s"])
    log(json.dumps({"phase": "gpt_race_best", "card": card,
                    "variant": best,
                    "tokens_per_s": results[best]["tokens_per_s"],
                    "ran": sorted(results),
                    "oom": [n for n, *_ in RACE if n not in results]}))
    del params, opt, restore
    gc.collect()
    torch.cuda.empty_cache()

    # the routes, one step each at ROUTE_LAYERS layers, remat "dots"
    cfg = dataclasses.replace(base, num_layers=ROUTE_LAYERS, remat=True,
                              remat_policy="dots")
    params = gpt.init_gpt_params(cfg, seed=0)
    opt = gpt.init_opt_state(params)
    restore = host_state(params, opt)
    tokens = train_tokens(torch, dev, cfg, TRAIN_BATCH, TRAIN_SEQ, 2)
    probe = torch.empty(0, device=dev)
    kernel_loss = None
    nl = ROUTE_LAYERS
    for name, env in ROUTES:
        restore()
        with env_set(**env):
            torch.cuda.synchronize()
            zero_launch_counts()
            loss = float(gpt.train_step(params, opt, tokens, cfg,
                                        **ADAMW)[0])
            got = launch_counts()
            route = ce_route(probe)
        attn = name not in ("xla", "attn_kill", "global_kill")
        want = {k: 0 for k in got}
        want.update(step_launches(nl, True, "dots", attn=attn,
                                  bwd=name != "bwd_kill",
                                  ce=name != "global_kill"))
        if kernel_loss is None:
            kernel_loss = loss
        # the same kernel forward gives the same loss; the plain
        # attention within phase 3's kernel-vs-plain tolerance
        tol = 1e-6 if attn else 2e-3
        ok = (got == want and math.isfinite(loss)
              and abs(loss - kernel_loss) <= tol * abs(kernel_loss)
              and route == ("jax" if name == "global_kill" else "pallas"))
        log(json.dumps({"phase": "gpt_route", "card": card, "route": name,
                        "env": env, "layers": nl, "loss": loss,
                        "loss_rel_diff_vs_default":
                            abs(loss - kernel_loss) / abs(kernel_loss),
                        "ce_route": route, "launches": got, "ok": ok}))
        if not ok:
            raise AssertionError(f"gpt route {name} ({env}): launches "
                                 f"{got} != {want}, loss {loss} vs "
                                 f"{kernel_loss} (rel {tol}), ce {route}")
        for k, v in got.items():
            total[k] = total.get(k, 0) + v
    del params, opt, restore, tokens
    torch.cuda.empty_cache()
    return total


def autotune_tiles(torch, dev, card):
    """Phase 3b's autotune: with PADDLE_TPU_AUTOTUNE=1 and the cache in a
    temporary directory, the bf16 forward at the GPT and the Llama train
    steps' shapes under each tile (time, error against the plain version
    within flash_tol, both tiles' bits compared); the first call a miss
    that times the candidates and caches the pick, the second a hit with
    `tuned` unchanged; an env tile outranking the cache; a foreign cache
    entry skipped and counted; an env tile the kernels lack raising.
    Returns {shape name: {tile: ms, "pick": tile}}."""
    import tempfile
    from paddle_tpu_torch.kernels import autotune
    from paddle_tpu_torch.kernels import flash_attention as fa
    ops = torch.ops.paddle_tpu_torch
    saved = (autotune._CACHE_PATH, dict(autotune._CACHE), autotune._loaded)
    out = {}
    with tempfile.TemporaryDirectory() as tmp, \
            env_set(PADDLE_TPU_AUTOTUNE="1"):
        autotune._CACHE_PATH = os.path.join(tmp, "autotune.json")
        autotune._CACHE.clear()
        autotune._loaded = False
        try:
            for label, (B, S, H, D, _) in (("gpt", ATTN_MAIN),
                                           ("llama", ATTN_LLAMA)):
                g = torch.Generator(device=dev).manual_seed(S + D)
                qkv = torch.randn(B, S, 3, H, D, generator=g,
                                  device=dev).to(torch.bfloat16)
                q, k, v = qkv.unbind(2)
                r_out, r_lse = fa.mha_fwd_ref(q, k, v, True)
                cands = fa.flash_block_candidates(D, q.dtype)
                row, outs = {}, {}
                for bq, bk in cands:
                    o, lse = fa.mha_fwd(q, k, v, causal=True, block_q=bq,
                                        block_k=bk)
                    torch.cuda.synchronize()
                    over = float(((o.float() - r_out.float()).abs()
                                  / flash_tol(r_out)).max())
                    lse_err = float((lse - r_lse).abs().max())
                    if not over <= 1.0 or not lse_err <= 1e-3:
                        raise AssertionError(
                            f"flash forward tile {(bq, bk)} at {label}: "
                            f"|err| / tol {over}, lse err {lse_err}")
                    ms = event_ms(torch, lambda: ops.flash_fwd(
                        q, k, v, True, S, bq, bk))
                    row[f"{bq}x{bk}"] = {"ms": ms, "err_over_tol": over,
                                         "lse_max_abs_err": lse_err}
                    outs[(bq, bk)] = (o, lse)
                (o1, l1), (o2, l2) = outs.values()
                same = torch.equal(o1.view(torch.int16),
                                   o2.view(torch.int16)) and \
                    torch.equal(l1, l2)
                st0 = autotune.autotune_status()
                fa.mha_fwd(q, k, v, causal=True)        # a miss: tunes
                st1 = autotune.autotune_status()
                sig = fa._flash_sig(q, k, True)
                pick = autotune.cached("flash_fwd", sig)
                fa.mha_fwd(q, k, v, causal=True)        # a hit
                st2 = autotune.autotune_status()
                if not (st1["tuned"] == st0["tuned"] + 1 and pick in cands
                        and st2["tuned"] == st1["tuned"]
                        and fa._fwd_blocks(q, k, True) == pick):
                    raise AssertionError(f"autotune at {label}: {st0} -> "
                                         f"{st1} -> {st2}, pick {pick}")
                other = next(c for c in cands if c != pick)
                with env_set(PADDLE_TPU_FLASH_BLOCK_Q=str(other[0])):
                    if fa._fwd_blocks(q, k, True) != other:
                        raise AssertionError("an env tile must outrank "
                                             "the cache")
                out[label] = {**row, "pick": list(pick),
                              "tiles_same_bits": same}
                log(json.dumps({"phase": "flash_fwd_tiles", "card": card,
                                "shape": [B, S, H, D], "tiles": row,
                                "same_bits_across_tiles": same,
                                "autotune_pick": list(pick),
                                "status": st2}))
                del qkv, q, k, v, r_out, r_lse, outs, o1, o2, l1, l2
            # a foreign entry (Pallas blocks) is skipped for the default
            # and counted; an env tile the kernels lack raises
            q = torch.randn(2, 256, 4, 64, device=dev).to(torch.bfloat16)
            sig = fa._flash_sig(q, q, True)
            autotune._CACHE[f"flash_fwd::{sig}"] = [512, 256]
            n0 = autotune.autotune_status()["foreign"]
            fa.mha_fwd(q, q, q, causal=True)
            n1 = autotune.autotune_status()["foreign"]
            try:
                with env_set(PADDLE_TPU_FLASH_BLOCK_Q="256"):
                    fa.mha_fwd(q, q, q, causal=True)
                raised = False
            except ValueError:
                raised = True
            persisted = json.load(open(autotune._CACHE_PATH))
            log(json.dumps({"phase": "autotune_rules", "foreign_counted":
                            n1 - n0, "env_tile_lacking_raised": raised,
                            "persisted": persisted}))
            if n1 != n0 + 1 or not raised or len(persisted) != 2:
                raise AssertionError("autotune rules: foreign "
                                     f"{n1 - n0}, raised {raised}, file "
                                     f"{persisted}")
        finally:
            autotune._CACHE_PATH = saved[0]
            autotune._CACHE.clear()
            autotune._CACHE.update(saved[1])
            autotune._loaded = saved[2]
    return out


# phase 3c: the GPT step with experts at the headline widths (FULL),
# MOE_LAYERS of its 24 layers for time (PERF.md section 4): 8 experts
# (Switch-Base-8's count) and the reference's MoE defaults
MOE = dict(num_experts=8, moe_gate="switch", expert_capacity_factor=1.25,
           moe_aux_weight=0.01)
MOE_LAYERS = 4
EXPERT_LEAVES = ("moe_up_w", "moe_up_b", "moe_down_w", "moe_down_b")


def gpt_leaves(L, experts=0):
    """{leaf: shape} of the GPT tree at the headline widths (FULL), L
    layers, with `experts` experts in place of the dense FFN (as
    models/gpt.py init_gpt_params draws it)."""
    D, V, S = FULL["hidden_size"], FULL["vocab_size"], FULL["max_seq_len"]
    F, E = 4 * D, experts
    out = {"wte": (V, D), "wpe": (S, D), "ln_f_scale": (D,),
           "ln_f_bias": (D,), "ln1_scale": (L, D), "ln1_bias": (L, D),
           "ln2_scale": (L, D), "ln2_bias": (L, D), "qkv_w": (L, D, 3 * D),
           "qkv_b": (L, 3 * D), "attn_out_w": (L, D, D),
           "attn_out_b": (L, D)}
    if E:
        out.update({"gate_w": (L, D, E), "moe_up_w": (L, E, D, F),
                    "moe_up_b": (L, E, F), "moe_down_w": (L, E, F, D),
                    "moe_down_b": (L, E, D)})
    else:
        out.update({"mlp_up_w": (L, D, F), "mlp_up_b": (L, F),
                    "mlp_down_w": (L, F, D), "mlp_down_b": (L, D)})
    return out


# phase 3c's tree: 17 leaves, 320,047,104 f32 parameters
GPT_MOE_LEAVES = gpt_leaves(MOE_LAYERS, MOE["num_experts"])


def gpt_step_launches(cfg, n_leaves):
    """Kernel launches of one GPT step under remat "full" with the CE on
    its default route and the fused update forced: the flash forward
    twice a layer (the forward and the recompute) and each backward
    kernel once, none under ring attention (its chunk updates are
    plain f32 torch, as the reference's are plain jnp); one CE pair; one
    update launch over every leaf."""
    L = cfg.num_layers
    flash = getattr(cfg, "context_parallel", "none") != "ring"
    return {"flash_fwd": 2 * L if flash else 0,
            "flash_bwd_dq": L if flash else 0,
            "flash_bwd_dkv": L if flash else 0,
            "ce_fwd": 1, "ce_bwd": 1, "leaf_update": 1,
            "leaf_update_leaves": n_leaves}


def active_params(params, cfg):
    """Parameters a token runs through: every non-expert leaf and k of the
    E experts' leaves (the router counted whole)."""
    from paddle_tpu_torch.parallel.moe import GATES
    k = GATES[cfg.moe_gate].top_k
    expert = sum(params[n].numel() for n in EXPERT_LEAVES)
    total = sum(p.numel() for p in params.values())
    return total - expert + expert * k // cfg.num_experts


@contextlib.contextmanager
def routing_record():
    """Each MoE layer's routing inside the body, as parallel/moe.py's
    route_tokens returns it: a list of (top-1 expert [T], keep [k, T])."""
    from paddle_tpu_torch.parallel import moe
    seen = []
    orig = moe.route_tokens

    def record(*args, **kw):
        r = orig(*args, **kw)
        seen.append((r.expert[0], r.keep))
        return r
    moe.route_tokens = record
    try:
        yield seen
    finally:
        moe.route_tokens = orig


def moe_forward(torch, gpt, params, tokens, cfg):
    """One forward under no_grad: (loss, aux, [top-1 expert a layer],
    dropped share of the (token, choice) pairs)."""
    with torch.no_grad(), routing_record() as seen:
        logits, aux = gpt._gpt_forward_impl(params, tokens[:, :-1], cfg)
        loss = gpt.fused_softmax_ce(logits, tokens[:, 1:]) \
            + cfg.moe_aux_weight * aux
    keep = torch.stack([kp for _, kp in seen])
    return (float(loss), float(aux), [e for e, _ in seen],
            1.0 - float(keep.float().mean()))


def moe_check(torch, gpt, params, opt, tokens, cfg, restore, label, card):
    """Step 1 of `cfg` on the kernels against the plain versions from one
    state: losses within 2e-3 relative, and the top-1 choices that
    differ between the two forwards counted (a bf16 difference in
    attention can move a near-tie token to another expert: printed
    beside the loss gap, not gated); then one train step each, their
    losses within 2e-3, the kernels' launches exactly one step's.
    Returns (the line, the kernel step's launches)."""
    k_loss, k_aux, k_top, k_drop = moe_forward(torch, gpt, params, tokens,
                                               cfg)
    with plain_versions():
        p_loss, p_aux, p_top, p_drop = moe_forward(torch, gpt, params,
                                                   tokens, cfg)
    flips = [int((a != b).sum()) for a, b in zip(k_top, p_top)]
    restore()
    zero_launch_counts()
    with forced_registry(fused_update="pallas"):
        s_k = float(gpt.train_step(params, opt, tokens, cfg, **ADAMW)[0])
    launches = launch_counts()
    restore()
    with plain_versions():
        s_p = float(gpt.train_step(params, opt, tokens, cfg, **ADAMW)[0])
    restore()
    want = gpt_step_launches(cfg, len(params))
    line = {"phase": f"{label}_kernel_vs_plain", "card": card,
            "gate": cfg.moe_gate, "experts": cfg.num_experts,
            "capacity_factor": cfg.expert_capacity_factor,
            "loss_kernel": k_loss, "loss_plain": p_loss,
            "loss_rel_diff": abs(k_loss - p_loss) / abs(p_loss),
            "aux_kernel": k_aux, "aux_plain": p_aux,
            "dropped_share_kernel": k_drop, "dropped_share_plain": p_drop,
            "top1_flips_by_layer": flips,
            "tokens_a_layer": int(k_top[0].numel()),
            "step_loss_kernel": s_k, "step_loss_plain": s_p,
            "step_launches": launches,
            "tolerance": "losses 2e-3 relative; flips counted, not gated"}
    log(json.dumps(line))
    bad = []
    if not all(math.isfinite(x) for x in (k_loss, p_loss, s_k, s_p)):
        bad.append("non-finite loss")
    if abs(k_loss - p_loss) > 2e-3 * abs(p_loss) or \
            abs(s_k - s_p) > 2e-3 * abs(s_p):
        bad.append("loss")
    if {k: launches.get(k, 0) for k in want} != want or any(
            v for k, v in launches.items() if k not in want):
        bad.append(f"launches, want {want}")
    if bad:
        raise AssertionError(f"{label} ({cfg.moe_gate}): {bad}: {line}")
    return line, launches


def moe_training(torch, dev, card):
    """Phase 3c: the GPT step with 8 experts (MOE) at the headline widths,
    MOE_LAYERS deep, remat "full", the CE on its default two-pass route
    and the fused update forced (one launch over the 17 leaves). From
    one starting state (kept on the host): the switch and the gshard
    step against the plain versions (moe_check), 5-step switch
    trajectories on each (within 1e-2), then 2 warm-up and 10 timed
    switch steps with the exact launches asserted (MFU from the active
    parameters), and a 2-step profile. Returns the launches over the 10
    timed steps and over the gshard step."""
    import dataclasses
    from paddle_tpu_torch.models import gpt
    cfg = gpt.GPTConfig(**dict(FULL, num_layers=MOE_LAYERS), remat=True,
                        remat_policy="full", **MOE)
    t0 = time.perf_counter()
    params = gpt.init_gpt_params(cfg, seed=0)
    shapes = {k: tuple(v.shape) for k, v in params.items()}
    if shapes != GPT_MOE_LEAVES:
        raise AssertionError(f"gpt moe leaves {shapes} != {GPT_MOE_LEAVES}")
    log(f"gpt_moe_train: params built in {time.perf_counter() - t0:.1f} s")
    opt = gpt.init_opt_state(params)
    tokens = train_tokens(torch, dev, cfg, TRAIN_BATCH, TRAIN_SEQ, 4)
    restore = host_state(params, opt)
    label = "gpt_moe_train"
    switch, _ = moe_check(torch, gpt, params, opt, tokens, cfg, restore,
                          label, card)
    gcfg = dataclasses.replace(cfg, moe_gate="gshard")
    _, gshard_launches = moe_check(torch, gpt, params, opt, tokens, gcfg,
                                   restore, label, card)
    traj = {}
    for name, ctx in (("kernel", functools.partial(
            forced_registry, fused_update="pallas")),
            ("plain", plain_versions)):
        restore()
        with ctx():
            traj[name] = [float(gpt.train_step(params, opt, tokens, cfg,
                                               **ADAMW)[0])
                          for _ in range(5)]
    rel = [abs(a - b) / abs(b) for a, b in zip(traj["kernel"],
                                               traj["plain"])]
    log(json.dumps({"phase": f"{label}_trajectory", "card": card,
                    "kernel": traj["kernel"], "plain": traj["plain"],
                    "rel_diff": rel}))
    if max(rel) > 1e-2 or abs(traj["kernel"][0] - switch["step_loss_kernel"]
                             ) > 1e-6 * abs(traj["kernel"][0]):
        raise AssertionError(f"{label} trajectories differ: {traj}")
    restore()
    del restore
    torch.cuda.empty_cache()
    n_active = active_params(params, cfg)
    with forced_registry(fused_update="pallas"):
        launches, line, step = timed_steps(
            torch, card, label, gpt, cfg, params, opt, tokens,
            gpt_step_launches(cfg, len(params)), flops_params=n_active,
            experts=cfg.num_experts, gate=cfg.moe_gate,
            capacity_factor=cfg.expert_capacity_factor,
            layers=MOE_LAYERS, active_params=n_active,
            expert_params=sum(params[n].numel() for n in EXPERT_LEAVES),
            mfu_formula="(6 * N_active + 12 * L * D * S) * tokens/s / "
                        "989e12; N_active = non-expert params + k * "
                        "(expert params / E), k = 1 (switch)",
            dropped_share=switch["dropped_share_kernel"],
            aux_loss=switch["aux_kernel"],
            top1_flips_vs_plain=sum(switch["top1_flips_by_layer"]))
        train_profile(torch, step, params, opt, tokens, card, label)
    del params, opt, step
    torch.cuda.empty_cache()
    return launches, gshard_launches


# phases 4, 6a and 6c (a) start from the same full-depth tree drawn from
# seed 0 (~15 s of numpy draws each time): drawn once on the host and
# kept until 6c (a) has copied it to the card
_LLAMA_HOST = {}


def llama_full_host():
    """The TinyLlama-width tree at full depth from seed 0, as CPU tensors
    (`init_llama_params(device="cpu")`, the draws every device copy of
    it equals), drawn once. Callers copy it or only read it."""
    if "params" not in _LLAMA_HOST:
        from paddle_tpu_torch.models import llama
        cfg = llama.LlamaConfig(**LLAMA)
        _LLAMA_HOST["params"] = llama.init_llama_params(cfg, seed=0,
                                                        device="cpu")
    return _LLAMA_HOST["params"]


def llama_training(torch, dev, card):
    """Phase 4, Llama at TinyLlama-1.1B widths, with the fused AdamW
    selected and the CE on its default route; then the primal-only eval
    loss. Returns (launches over the 10 timed steps, {"train": the
    timed line, "trajectory": the kernels' 5 losses from the starting
    state, "eval": the eval line})."""
    from paddle_tpu_torch.models import llama
    cfg = llama.LlamaConfig(**LLAMA, remat=True)
    L = cfg.num_layers
    t0 = time.perf_counter()
    params = {k: v.to(dev) for k, v in llama_full_host().items()}
    shapes = {k: tuple(v.shape) for k, v in params.items()}
    if shapes != LLAMA_LEAVES:
        raise AssertionError(f"llama leaves {shapes} != {LLAMA_LEAVES}")
    log(f"llama_train: params built in {time.perf_counter() - t0:.1f} s")
    with forced_registry(fused_update="pallas"):
        launches, train_line, tokens, traj = train_phase(
            torch, dev, card, "llama_train", llama, cfg, params,
            LLAMA_BATCH, LLAMA_SEQ, 3,
            {"flash_fwd": 2 * L, "flash_bwd_dq": L, "flash_bwd_dkv": L,
             "ce_fwd": 1, "ce_bwd": 1, "leaf_update": 1,
             "leaf_update_leaves": len(params)})

    # a primal-only call (an eval loss) launches the CE forward alone
    torch.cuda.synchronize()
    zero_launch_counts()
    t_s = time.perf_counter()
    with torch.no_grad():
        loss = float(llama.llama_loss(params, tokens, cfg))
    eval_ms = (time.perf_counter() - t_s) * 1e3
    got = launch_counts()
    want = {k: 0 for k in got}
    want.update(flash_fwd=L, ce_fwd=1)
    line = {"phase": "llama_eval_loss", "card": card, "loss": loss,
            "ms": eval_ms, "launches": got}
    log(json.dumps(line))
    if got != want or not math.isfinite(loss):
        raise AssertionError(f"eval loss under no_grad: launches {got} != "
                             f"{want}, loss {loss}")
    del params, tokens
    torch.cuda.empty_cache()
    return launches, {"train": train_line, "trajectory": traj, "eval": line}


# how long a profiled serving window stays open after its last sync
PROFILE_TAIL_S = 0.25


def listed_by_dispatch(prof, kernel, span="serving.decode_tick"):
    """The device records whose name holds `kernel` in a finished
    torch.profiler window, binned by their start against the starts of
    the engine's `span` ranges (each dispatch's `RecordEvent`):
    [before the first span, in the first, ...]. A dispatch ends in its
    host pull, so its kernels start after its span opens and before the
    next one does. None where the trace holds no such span."""
    import bisect

    from torch.autograd import DeviceType
    evs = prof.profiler.kineto_results.events()
    starts = sorted(e.start_ns() for e in evs if e.name() == span
                    and e.device_type() == DeviceType.CPU)
    if not starts:
        return None
    bins = [0] * (len(starts) + 1)
    for e in evs:
        if e.device_type() == DeviceType.CUDA and kernel in e.name():
            bins[bisect.bisect_right(starts, e.start_ns())] += 1
    return bins


def tick_profile(torch, eng, prompts, card, pre=""):
    """Where a decode tick's time goes: 8 slots decoding under
    torch.profiler, after their prefills and first tick: the 15 ticks
    left of 17 new tokens, or under multi-tick 4 dispatches (each a CUDA
    graph replay) of requests long enough to outlast them. Prints the
    device busy share of the window and the device time by kernel name
    (top 12); under multi-tick also each dispatch's time from CUDA
    events around it. Fails unless the profiler lists at least 99% and
    at most 100% of the int8 kernel launches the engine counts in the
    window, and under multi-tick unless every dispatch was a graph
    replay: so the replays ran `qmm_mma_kernel` (a replay of a plain
    version would list none; each capture's exact count is
    `check_launches`'s). Not exactly 100%: late in this script's process
    the profiler has dropped a few device records of a window (3-5 of a
    graphed window's ~2,480 int8 ones, once 8 of an eager window's 435),
    while the same engine profiled in a fresh process lists every one.
    The window stays open `PROFILE_TAIL_S` after its last sync, so the
    profiler's collector has the window's last records before it stops,
    and the line prints the listed int8 records by dispatch
    (`listed_by_dispatch`), so a drop names where it fell."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.kernels import quant_matmul as qm
    mt = eng.mt_k > 1
    n_new = 1 + 5 * eng._tick_span if mt else 17
    reqs = [eng.submit(p[:64], n_new) for p in prompts[:8]]
    eng.step()                                   # the 8 prefills
    torch.cuda.synchronize()
    c0 = dict(eng.counters)
    events = []
    if eng.mt_k > 1:
        dispatch = eng._dispatch

        def timed(sampling):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = dispatch(sampling)
            b.record()
            events.append((a, b))
            return out
        eng._dispatch = timed
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        n0 = qm.launches
        t0 = time.perf_counter()
        if mt:
            for _ in range(4):
                eng.step()
        else:
            eng.drain()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        time.sleep(PROFILE_TAIL_S)
    eager = qm.launches - n0
    n_disp = eng.counters["decode_ticks"] - c0["decode_ticks"]
    n_replay = eng.counters["graph_replays"] - c0["graph_replays"]
    n_qmm = eng.counters["quant_matmuls"] - c0["quant_matmuls"]
    if mt:
        del eng._dispatch
        eng.drain()
    assert all(r.finish_reason == "length" for r in reqs)

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    # device-side events only (the kernels and copies themselves): the
    # operator-level rows repeat their kernels' time
    rows = [(dev_us(e), e.count, e.key) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    profiled = sum(n for _, n, k in rows if "qmm_mma" in k)
    by_dispatch = listed_by_dispatch(prof, "qmm_mma")
    if not 0.99 * n_qmm <= profiled <= n_qmm or (
            mt and (n_replay != n_disp or eager)):
        raise AssertionError(
            f"{pre}tick_profile: the profiler lists {profiled} int8 kernel "
            f"launches, the engine counts {n_qmm} over {n_disp} dispatches "
            f"({n_replay} graph replays, {eager} eager launches); listed "
            f"by dispatch (before the first, then each): {by_dispatch}")
    out = {"phase": f"{pre}tick_profile", "card": card,
           "dispatches": n_disp, "ticks": n_disp * eng.mt_k,
           "slots": 8, "wall_ms": wall_ms,
           "int8_listed": profiled, "int8_engine": n_qmm,
           "int8_listed_by_dispatch": by_dispatch,
           "device_busy_ms": busy_ms if rows else "not measured",
           "device_busy_share": busy_ms / wall_ms if rows
           else "not measured",
           "top_kernels": [{"name": k[:90], "device_ms": us / 1e3,
                            "calls": n} for us, n, k in rows[:12]]}
    if eng.mt_k > 1:
        ms = [a.elapsed_time(b) for a, b in events]
        out.update({
            "graph_replays": n_replay,
            "replay_launches_profiled": profiled,
            "dispatch_event_ms": ms,
            "inside_dispatch_share": sum(ms) / wall_ms})
    log(json.dumps(out))
    return out


def family_fns(family):
    """(forward_cached, init_kv_cache, greedy_generate) of a model
    family, "gpt" or "llama"."""
    from paddle_tpu_torch.models import gpt, llama
    if family == "gpt":
        return gpt.gpt_forward_cached, gpt.init_kv_cache, gpt.greedy_generate
    return llama.llama_forward_cached, llama.init_kv_cache, \
        llama.greedy_generate


def forced_logits(torch, qmm, qp, prompt, tokens, cfg, dev, max_len,
                  family="gpt"):
    """The logits each of `tokens` is picked from on greedy_generate's
    path, the stream teacher-forced: the bucketed prompt's prefill, then
    one-token steps through the KV cache, each fed the token before it.
    prompt [T0] and tokens on the host; returns [len(tokens), V] f32."""
    from paddle_tpu_torch.models.decode import prompt_bucket
    fwd, init_cache, _ = family_fns(family)
    T0 = len(prompt)
    padded = torch.zeros((1, prompt_bucket(T0, max_len)), dtype=torch.int64,
                         device=dev)
    padded[0, :T0] = torch.as_tensor(prompt, device=dev)
    cache = init_cache(cfg, 1, max_len, device=dev)
    with torch.no_grad():
        lg, cache = fwd(qp, padded, cache, 0, cfg, qmm=qmm)
        rows = [lg[0, T0 - 1].float()]
        for i, tok in enumerate(tokens[:-1]):
            step = torch.tensor([[tok]], dtype=torch.int64, device=dev)
            lg, cache = fwd(qp, step, cache, T0 + i, cfg, qmm=qmm)
            rows.append(lg[0, -1].float())
    return torch.stack(rows)


def f64_checked(torch, qmm, qmm_ref, per_pass, keep=None, weights64=None):
    """`qmm` with every call's output held to the f64 bound on its own
    input (`f64_oracle`, with its `weights64` cache), the plain version
    (`qmm_ref`; None: not run) on the same input beside it. Returns (the
    wrapped qmm, stats): the calls, those of the
    kernel within the bound (in all and by forward, forwards counted in
    passes of `per_pass` calls), the worst ulps and bound shares of both
    versions, the first call outside the bound, and under "head" the
    last call (x, w_q, scale, y) of forward `keep`."""
    stats = {"per_pass": per_pass, "calls": 0,
             "kernel_calls_within_bound": 0,
             "within_by_forward": [], "kernel_max_ulps": 0.0,
             "kernel_max_bound_share": 0.0, "plain_max_ulps": 0.0,
             "plain_max_bound_share": 0.0, "first_outside": None}

    def checked(x, w_q, scale):
        y = qmm(x, w_q, scale)
        oracle = f64_oracle(torch, x, w_q, scale, weights64)
        kv = f64_verdict(torch, y, oracle)
        pv = kv if qmm_ref is None else f64_verdict(
            torch, qmm_ref(x, w_q, scale), oracle)
        fwd, call = divmod(stats["calls"], per_pass)
        if call == 0:
            stats["within_by_forward"].append(0)
        stats["within_by_forward"][-1] += kv["ok"]
        stats["kernel_calls_within_bound"] += kv["ok"]
        if not kv["ok"] and stats["first_outside"] is None:
            stats["first_outside"] = {
                "forward": fwd, "call": call, "M": x.numel() // x.shape[-1],
                "K": w_q.shape[0], "N": w_q.shape[1], **kv}
        for who, v in (("kernel", kv), ("plain", pv)):
            for k in ("max_ulps", "max_bound_share"):
                stats[f"{who}_{k}"] = max(stats[f"{who}_{k}"], v[k])
        if fwd == keep and call == per_pass - 1:
            stats["head"] = (x, w_q, scale, y)
        stats["calls"] += 1
        return y
    return checked, stats


def greedy_check(torch, qmm, qmm_ref, qp, prompt, cfg, dev, n=16,
                 max_len=1024, logit_tol=0.05, family="gpt"):
    """n greedy tokens from `prompt` [T0] (host ints) with the kernel
    (`qmm`) and with the plain version (`qmm_ref`), on the family's
    greedy_generate decode path (M = 1 steps, the path that splits K).
    Each stream is replayed teacher-forced through both versions
    (`forced_logits`):
    - each version's replay of its own stream gives that stream back;
    - at every step of each stream, the two versions' logits on the same
      prefix agree within `logit_tol` of the plain logits' span (the
      prefill check's tolerance), so every token of both streams comes
      from logits that agree;
    - every int8 call of the kernel's replays, the prefill and each
      step, lies within the f64 bound on its own input (`f64_checked`):
      a split dropped or doubled, or a wrong scale, is orders past it;
    - GPT: where the streams part, the first step that differs is a
      tie: the two tokens within one bf16 step (2^-7 of the larger
      logit) in both versions' logits; and on the plain stream the
      kernel differs from the plain pick nowhere else beyond such a tie.
    The dequant-matmul is the f32 sum of exact products in another order
    than the plain version's, rounded once to bf16, so logits one step
    apart can swap; past a parting the streams' prefixes differ, and the
    kernel's stream is held to the logit tolerance. Llama's 22-layer
    stack carries such rounding differences past one bf16 step before
    the head, so for Llama the partings are held to the f64 bound of
    every call instead of the one-step rule.

    report["f64_calls"] has the bound's counts and worst shares;
    report["f64_parting"] the f64 logits of the two tokens at the first
    parting (at step 2 where the streams agree) from the kernel's own
    head input, beside the kernel's, the plain version's on that input
    and the plain forward's: a measurement, not part of the verdict.
    Returns the report; report["ok"] says whether it passed."""
    greedy_generate = family_fns(family)[2]
    T0 = len(prompt)
    p = torch.as_tensor(prompt, device=dev)[None]
    gk, gr = (greedy_generate(qp, p, cfg, n, max_len=max_len, qmm=f)[
        0, T0:].tolist() for f in (qmm, qmm_ref))
    j0 = next((j for j in range(n) if gk[j] != gr[j]), None)
    at = 2 if j0 is None else j0
    per_pass = cfg.num_layers * sum(
        k.endswith("_q") and k != "head_q" for k in qp) + ("head_q" in qp)
    checked, f64 = f64_checked(torch, qmm, qmm_ref, per_pass, keep=at)

    def replay(f, stream):
        return forced_logits(torch, f, qp, prompt, stream, cfg, dev, max_len,
                             family)
    k_on_k, p_on_p = replay(checked, gk), replay(qmm_ref, gr)
    k_on_p = k_on_k if gk == gr else replay(checked, gr)
    p_on_k = p_on_p if gk == gr else replay(qmm_ref, gk)
    report = {"greedy16_kernel": gk, "greedy16_plain": gr,
              "greedy16_equal": gk == gr,
              "replays_reproduce": (k_on_k.argmax(-1).tolist() == gk
                                    and p_on_p.argmax(-1).tolist() == gr)}
    worst = 0.0
    for lk, lp in ((k_on_p, p_on_p), (k_on_k, p_on_k)):
        err = (lk - lp).abs().amax(-1) / lp.abs().amax(-1)
        worst = max(worst, float(err.max()))
    report["decode_logit_err_over_span"] = worst

    def one_step(lg, a, b):
        hi = max(float(lg[a]), float(lg[b]))
        return abs(float(lg[a]) - float(lg[b])) <= 2.0 ** -7 * abs(hi)
    steps = []
    for name, lg, stream in (("plain stream on the kernel", k_on_p, gr),
                             ("kernel stream on the plain", p_on_k, gk)):
        for j, tok in enumerate(stream):
            top = int(lg[j].argmax())
            if top != tok:
                steps.append({"replay": name, "step": j, "token": tok,
                              "argmax": top, "logits": [float(lg[j, tok]),
                                                        float(lg[j, top])],
                              "within_one_step": one_step(lg[j], tok, top)})
    report["differing_steps"] = steps
    report["f64_parting"] = f64_parting(torch, qmm_ref, f64, at, gk, gr,
                                        p_on_p, len(prompt), family)
    report["f64_calls"] = {k: v for k, v in f64.items() if k != "head"}
    f64_ok = f64["kernel_calls_within_bound"] == f64["calls"]
    report["f64_calls"]["ok"] = f64_ok
    parted = True
    if j0 is not None:
        report["first_split_step"] = j0
        if family == "gpt":
            parted = (one_step(k_on_p[j0], gk[j0], gr[j0])
                      and one_step(p_on_p[j0], gk[j0], gr[j0])
                      and all(s["within_one_step"] for s in steps
                              if s["replay"] == "plain stream on the kernel"))
    report["ok"] = (report["replays_reproduce"] and worst <= logit_tol
                    and f64_ok and parted)
    return report


def f64_parting(torch, qmm_ref, f64, step, gk, gr, p_on_p, T0, family):
    """The head's f64 logits at greedy step `step` from the kernel's own
    head input (`f64_checked`'s "head"), for the two tokens there (gk's
    and gr's, or the f64 top two where they agree), beside the kernel's,
    the plain version's on the same input and the plain forward's
    (`p_on_p`); and how that step's forward fared against the bound."""
    x, w_q, scale, y = f64["head"]
    row = T0 - 1 if step == 0 else 0             # the prefill's last real
    V = w_q.shape[1]
    y64 = f64_oracle(torch, x, w_q, scale)[0][row]
    y = y.reshape(-1, V)[row].float()
    plain_head = qmm_ref(x, w_q, scale).reshape(-1, V)[row].float()
    toks = ([gk[step], gr[step]] if gk[step] != gr[step]
            else y64.topk(2).indices.tolist())
    return {"phase": f"{'' if family == 'gpt' else family + '_'}"
                     "qmm_f64_replay",
            "family": family, "step": step, "calls": f64["per_pass"],
            "kernel_calls_within_bound":
                f64["within_by_forward"][step],
            "tokens": {str(t): {
                "f64": float(y64[t]), "kernel": float(y[t]),
                "plain_on_the_same_input": float(plain_head[t]),
                "plain_forward": float(p_on_p[step, t])} for t in toks},
            "f64_prefers": max(toks, key=lambda t: float(y64[t])),
            "plain_on_the_same_input_picks": int(plain_head.argmax())}


def serve(torch, qm, dev, card, family, cfg, params, prompts, max_len,
          per_pass):
    """One family's int8 serving phase (phases 5 and 5b): the engine over
    `prompts` (64 new tokens each, requests 3 and 11 sampled with top-k)
    on 8 slots, its launches asserted at `per_pass` a prefill and a tick;
    the prefill logits and the greedy check (with its f64 bound on every
    call) against the plain version; a tick profile; a 2-request fp
    engine. Returns (launches on the main path, summary dict)."""
    from paddle_tpu_torch.inference import ServingEngine
    from paddle_tpu_torch.kernels import threefry as tf
    from paddle_tpu_torch.models.decode import prompt_bucket
    fwd, init_cache, _ = family_fns(family)
    pre = "" if family == "gpt" else family + "_"
    t0 = time.perf_counter()
    # weights drawn on the host from a seed: the engine quantizes them
    # there and uploads only the int8 tree (the fp matmul leaves are
    # dropped before they would reach the card)
    eng = ServingEngine(params, cfg, family=family, num_slots=8,
                        max_len=max_len, max_top_k=50, seed=0, quant="int8")
    st = eng.quant_stats()
    sizes = {"quant_tree_bytes": st["quant_bytes"], "fp_bytes": st["fp_bytes"],
             "int8_block_bytes": sum(
                 v.numel() for k, v in eng._params.items()
                 if k.endswith("_q") and k != "head_q"),
             "head_q_bytes": eng._params["head_q"].numel(),
             "wte_bytes": eng._params["wte"].numel()
             * eng._params["wte"].element_size(),
             "kv_cache_bytes": sum(c.numel() * c.element_size()
                                   for c in eng._cache.values()),
             "kv_cache_shape": list(eng._cache["k"].shape)}
    log(json.dumps({"phase": f"{pre}serving_build",
                    "seconds": time.perf_counter() - t0, **sizes}))
    sampled = {3: (0.8, 40), 11: (1.0, 20)}
    # warm-up: CUDA context, allocator and library handles
    eng.generate([prompts[0][:16]], 4)
    torch.cuda.synchronize()
    n_pre0 = eng.counters["prefills"]
    n_tick0 = eng.counters["decode_ticks"]
    qmm0 = eng.counters["quant_matmuls"]
    n_tick_ms0 = len(eng.tick_ms)
    n_pf_ms0 = len(eng.prefill_ms)
    torch.cuda.reset_peak_memory_stats()
    allocated0 = torch.cuda.memory_allocated()

    c0 = dict(eng.counters)
    qm.launches = 0                          # the main path starts here
    tf.launches["threefry_bits"] = 0
    tf_cap0 = tf.captured
    t_run = time.perf_counter()
    reqs = [eng.submit(p, 64, temperature=sampled.get(i, (0.0, 0))[0],
                       top_k=sampled.get(i, (0.0, 0))[1])
            for i, p in enumerate(prompts)]
    eng.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_run
    launches = qm.launches                   # ... and ends here
    check_draws(eng, family, {k: v - c0[k] for k, v in eng.counters.items()},
                tf.launches["threefry_bits"], tf.captured - tf_cap0)

    n_pre = eng.counters["prefills"] - n_pre0
    n_tick = eng.counters["decode_ticks"] - n_tick0
    reasons = [r.finish_reason for r in reqs]
    if any(r != "length" for r in reasons):
        raise AssertionError(f"{family} finish reasons {reasons}")
    if launches != per_pass * (n_pre + n_tick) or \
            eng.counters["quant_matmuls"] - qmm0 != launches:
        raise AssertionError(
            f"{family} kernel launches {launches} != {per_pass} x ({n_pre} "
            f"prefills + {n_tick} ticks)")
    for r in reqs:
        toks = np.asarray(r.tokens)
        if len(toks) != 64 or toks.min() < 0 or toks.max() >= cfg.vocab_size:
            raise AssertionError(f"request {r.id}: bad tokens {toks[:8]}")
    tick_ms = list(eng.tick_ms)[n_tick_ms0:]
    pf_ms = list(eng.prefill_ms)[n_pf_ms0:]
    summary = {
        "phase": f"{pre}serving", "quant": "int8", "card": card,
        "requests": len(reqs), "new_tokens": 64 * len(reqs),
        "prompt_lens": [len(p) for p in prompts],
        "prefills": n_pre, "decode_ticks": n_tick,
        "launches": launches, "launches_per_pass": per_pass,
        "wall_s": wall, "tokens_per_s": 64 * len(reqs) / wall,
        "tick_ms_p50": statistics.median(tick_ms),
        "tick_ms_p90": float(np.percentile(tick_ms, 90)),
        "prefill_ms_p50": statistics.median(pf_ms),
        "prefill_ms_max": max(pf_ms),
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "memory_allocated_at_start_bytes": allocated0,
    }
    log(json.dumps(summary))
    summary["streams"] = [list(r.tokens) for r in reqs]

    # the kernel's forward against the same forward on the plain version
    qp = eng._params
    t0p = len(prompts[0])
    tb = prompt_bucket(t0p, max_len)
    padded = torch.zeros((1, tb), dtype=torch.int64, device=dev)
    padded[0, :t0p] = torch.as_tensor(prompts[0], device=dev)
    with torch.no_grad():
        lk, _ = fwd(qp, padded, init_cache(cfg, 1, tb, device=dev), 0, cfg,
                    qmm=qm.quant_matmul)
        lr, _ = fwd(qp, padded, init_cache(cfg, 1, tb, device=dev), 0, cfg,
                    qmm=qm.quant_matmul_ref)
    lk = lk[0, :t0p].float()
    lr = lr[0, :t0p].float()
    logit_err = float((lk - lr).abs().max())
    span = float(lr.abs().max())
    if not bool(torch.isfinite(lk).all()) or logit_err > 0.05 * span:
        raise AssertionError(f"{family} prefill logits: kernel vs plain max "
                             f"|err| {logit_err} > 5% of the logit span "
                             f"{span}")
    greedy = greedy_check(torch, qm.quant_matmul, qm.quant_matmul_ref, qp,
                          prompts[0], cfg, dev, max_len=max_len,
                          family=family)
    parting = greedy.pop("f64_parting")
    log(json.dumps({"phase": f"{pre}reference", "prefill_logit_max_abs_err":
                    logit_err, "logit_span": span, "prompt0_len": t0p,
                    "prompt0_bucket": tb, **greedy,
                    "engine_request0_first16": reqs[0].tokens[:16]}))
    log(json.dumps(parting))
    if not greedy["ok"]:
        raise AssertionError(f"{family} greedy check failed: "
                             f"{json.dumps(greedy)}")
    summary["profile"] = tick_profile(torch, eng, prompts, card, pre)
    del eng, qp

    # the fp engine (quant="off") shares every module but the kernel
    t0 = time.perf_counter()
    fp = ServingEngine(params, cfg, family=family, num_slots=2,
                       max_len=max_len, quant="off")
    out = fp.generate([p[:64] for p in prompts[:2]], 16)
    torch.cuda.synchronize()
    fp_reasons = [len(o) for o in out]
    if fp_reasons != [16, 16]:
        raise AssertionError(f"{family} fp engine emitted {fp_reasons}")
    log(json.dumps({"phase": f"{pre}serving_fp", "quant": "off",
                    "card": card, "requests": 2,
                    "wall_s": time.perf_counter() - t0,
                    "tick_ms_p50": statistics.median(fp.tick_ms),
                    "prefill_ms_p50": statistics.median(fp.prefill_ms)}))
    del fp
    torch.cuda.empty_cache()
    return launches, summary


def gpt_host_params():
    """Phases 5 and 5f's GPT at the headline width, its weights drawn on
    the host from seed 0 (each engine quantizes them there and uploads
    only the int8 tree)."""
    from paddle_tpu_torch.models.gpt import GPTConfig, init_gpt_params
    cfg = GPTConfig(**FULL)
    return cfg, init_gpt_params(cfg, seed=0, device="cpu")


def serving(torch, qm, dev, card, cfg, params):
    """Phase 5, GPT at the headline width: 16 requests, prompts of
    16..512 tokens (seed 1), max_len 1024. Returns (launches on the main
    path, summary dict)."""
    rng = np.random.default_rng(1)
    lens = rng.integers(16, 513, size=16)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)) for n in lens]
    per_pass = sum(pass_calls(LEAF_KN, cfg.num_layers).values())
    return serve(torch, qm, dev, card, "gpt", cfg, params, prompts, 1024,
                 per_pass)


# phase 5f: the GPT engine of phase 5 under the reference's serving fault
# kinds, with its telemetry, tracing and SLO records on
CHAOS_NEW = 8                   # new tokens a request
# the K = 4 and spec scenarios': slots still decode at their tick 2
CHAOS_NEW_LONG = 12
CHAOS_SLOTS = 4                 # a scenario's slots and requests
CHAOS_K4_REQUESTS = 6           # the K = 4 scenarios': 2 wait to start
CHAOS_SAMPLED = {3: (0.8, 40)}  # a scenario's sampled request
TELE_SAMPLED = {3: (0.8, 40), 6: (1.0, 20)}
CHAOS_PAGED = dict(kv_layout="paged", page_size=16)
CHAOS_CHUNK = 128               # (a)'s and (c)'s prefill chunk, paged
CHAOS_K = 4
# (a)'s engines: (label, knobs, telemetry off/on runs in this order)
TELE_ENGINES = (
    ("dense", {}, ("off", "on", "on", "off")),
    ("paged", dict(CHAOS_PAGED, prefill_chunk=CHAOS_CHUNK),
     ("off", "on")),
    ("spec", dict(spec_decode="spec", gamma=4, draft_layers=2),
     ("off", "on")),
    ("dense_k4", dict(multi_tick=CHAOS_K), ("off", "on", "on", "off")))


def chaos_prompts(vocab, n, seed, lo=16, hi=160):
    rng = np.random.default_rng(seed)
    lens = rng.integers(lo, hi + 1, size=n)
    return [rng.integers(0, vocab, size=int(k)) for k in lens]


def cuda_sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serving_counters():
    """{name: value} of the port's serving.* monitor counters."""
    from paddle_tpu_torch.profiler import monitor
    reg = monitor.registry()
    return {k: reg.get(k).value for k in monitor.snapshot()
            if k.startswith("serving.") and reg.get(k).kind == "counter"}


def submit_all(prompts, sampled, n=CHAOS_NEW, **kw):
    """A drive: every prompt submitted (`sampled` {index: (temperature,
    top_k)}), then the engine stepped until idle."""
    def drive(eng):
        reqs = [eng.submit(p, n, temperature=sampled.get(i, (0.0, 0))[0],
                           top_k=sampled.get(i, (0.0, 0))[1], **kw)
                for i, p in enumerate(prompts)]
        while eng.has_work():
            eng.step()
        return reqs
    return drive


def host_attended(eng, toks, positions, active):
    """The cache tokens a dispatch's attention admitted, from the host
    mirrors before it and the emission matrix it returned: a step a slot
    was alive attends its position + 1 (non-spec: each column before
    MT_PAD; the single spec tick: each active slot once)."""
    from paddle_tpu_torch.inference.multi_tick import MT_PAD
    total = 0
    for i in np.nonzero(active)[0]:
        if eng.spec:
            total += int(positions[i]) + 1
            continue
        row = toks[i].tolist()
        n = row.index(MT_PAD) if MT_PAD in row else len(row)
        total += sum(int(positions[i]) + j + 1 for j in range(n))
    return total


def chaos_run(torch, qm, dev, eng, drive, label, per_pass, per_tick,
              spec=None, sdir=None, detail=False):
    """One engine run of phase 5f: the flight recorder pointed at
    `sdir`/flight, the fault `spec` installed with a once-dir of its own,
    the kernels' counts zeroed where the run starts and read where it
    ends. Holds the int8 kernel's launches to the path's passes and
    dispatches (`check_launches`, the engine's `serving.quant_matmuls`
    to them plus the replays' launches), the sampler's to its draws
    (`check_draws`), and every request to exactly one terminal reason
    and one terminal span. With `detail` it counts the pulls and works
    out each dispatch's `attended` from the host mirrors."""
    from paddle_tpu_torch.inference import TERMINAL_REASONS
    from paddle_tpu_torch.kernels import threefry as tf
    from paddle_tpu_torch.profiler import flight_recorder, tracing
    from paddle_tpu_torch.testing import faults
    rec = flight_recorder.recorder()
    fdir = os.path.join(sdir, "flight") if sdir else None
    if fdir:
        os.makedirs(fdir, exist_ok=True)
    rec.clear()
    rec.set_dir(fdir)
    tracing.clear()
    warm = count_warmups(torch, qm, eng) if eng.mt_k > 1 else []
    pulls, attended, snap = [0], [], []
    if detail:
        pull, dispatch = eng._pull, eng._dispatch
        apply_ = (eng._apply_spec_emissions if eng.spec
                  else eng._apply_multi_emissions)

        def counted_pull(value, stall_s=0.0):
            pulls[0] += 1
            return pull(value, stall_s)

        def snapped(sampling):
            snap.append((eng._positions.copy(), eng._active.copy()))
            return dispatch(sampling)

        def applied(toks, events, tick_now):
            attended.append(host_attended(eng, toks, *snap[-1]))
            return apply_(toks, events, tick_now)
        eng._pull, eng._dispatch = counted_pull, snapped
        if eng.spec:
            eng._apply_spec_emissions = applied
        else:
            eng._apply_multi_emissions = applied
    n_rec0 = len(eng.tick_records())
    n_tick_ms0 = len(eng.tick_ms)
    m0, c0 = serving_counters(), dict(eng.counters)
    cuda_sync(torch, dev)
    qm.launches = 0                          # the main path starts here
    cap0 = qm.captured
    tf.launches["threefry_bits"] = 0
    tf_cap0 = tf.captured
    if spec:
        faults.install(spec, once_dir=os.path.join(sdir, "once"))
    t0 = time.perf_counter()
    try:
        reqs = drive(eng)
        cuda_sync(torch, dev)
    finally:
        if spec:
            faults.uninstall()
        rec.set_dir(None)
        for name in ("_pull", "_dispatch", "_multi_ticks",
                     "_apply_spec_emissions", "_apply_multi_emissions"):
            eng.__dict__.pop(name, None)      # this run's wrappers
    wall = time.perf_counter() - t0
    launches = qm.launches                   # ... and ends here
    c = {k: v - c0[k] for k, v in eng.counters.items()}
    m1 = serving_counters()
    m = {k: v - m0.get(k, 0) for k, v in m1.items() if v - m0.get(k, 0)}
    check_launches(eng, label, c, launches, per_pass, per_tick, warm,
                   qm.captured - cap0)
    check_draws(eng, label, c, tf.launches["threefry_bits"],
                tf.captured - tf_cap0)
    replays = c["graph_replays"] * eng.mt_k * per_tick
    if m.get("serving.quant_matmuls", 0) != launches + replays:
        raise AssertionError(
            f"{label}: serving.quant_matmuls moved "
            f"{m.get('serving.quant_matmuls', 0)}, the kernel launched "
            f"{launches} through the wrapper + {replays} in replays")
    tr = tracing.tracer()
    for r in reqs:
        terms = tr.terminal_spans(r.trace.trace_id) if r.trace else [None]
        if (not r.done or r.finish_reason not in TERMINAL_REASONS
                or r.slot is not None or len(terms) != 1
                or (r.trace and terms[0].attrs["reason"]
                    != r.finish_reason)):
            raise AssertionError(
                f"{label}: request {r.id} done={r.done} reason="
                f"{r.finish_reason} slot={r.slot}, {len(terms)} terminal "
                "spans")
    dumps = []
    if fdir:
        for name in sorted(os.listdir(fdir)):
            doc = flight_recorder.load_dump(os.path.join(fdir, name))
            dumps.append(doc["reason"])
    ticks = [r for r in eng.tick_records()[n_rec0:]
             if r["kind"] == "serving_tick"]
    return {"streams": [list(map(int, r.tokens)) for r in reqs],
            "reasons": [r.finish_reason for r in reqs], "counters": c,
            "monitor": m, "launches": launches, "replays": replays,
            "draws": tf.launches["threefry_bits"], "dumps": dumps,
            "pulls": pulls[0], "attended": attended, "ticks": ticks,
            "tick_ms": list(eng.tick_ms)[n_tick_ms0:], "wall_s": wall}


def chaos_check(name, out, base, reasons=None, monitor=None,
                at_least=None, dump=None, captures=True):
    """A scenario's three invariants against the fault-free run `base`
    of the same engine and drive: every request ends in one terminal
    reason (`chaos_run` checked the spans); the finished streams equal
    the fault-free run's to the bit and the others are prefixes of them;
    an eventful fault leaves a flight dump `dump` names (loaded), and
    the CUDA graph captures stay at the fault-free run's count. Then the
    serving.* counters: `monitor` exact deltas, `at_least` lower bounds,
    and the finish reasons where `reasons` gives them. Returns the
    scenario's JSON line."""
    bad = []
    for i, (got, want, why) in enumerate(zip(out["streams"],
                                             base["streams"],
                                             out["reasons"])):
        ok = (got == want if why in ("length", "eos")
              else got == want[:len(got)])
        if not ok:
            bad.append(f"request {i} ({why}) {got[:6]} vs {want[:6]}")
    if reasons is not None and out["reasons"] != reasons:
        bad.append(f"reasons {out['reasons']} != {reasons}")
    for k, v in (monitor or {}).items():
        if out["monitor"].get(k, 0) != v:
            bad.append(f"{k} moved {out['monitor'].get(k, 0)} != {v}")
    for k, v in (at_least or {}).items():
        if out["monitor"].get(k, 0) < v:
            bad.append(f"{k} moved {out['monitor'].get(k, 0)} < {v}")
    if dump and not any(dump in d for d in out["dumps"]):
        bad.append(f"no {dump!r} flight dump in {out['dumps']}")
    if captures and out["counters"]["graph_captures"] != \
            base["counters"]["graph_captures"]:
        bad.append(f"{out['counters']['graph_captures']} captures != the "
                   f"clean run's {base['counters']['graph_captures']}")
    line = {"phase": "gpt_serving_chaos", "scenario": name,
            "ok": not bad, "reasons": out["reasons"],
            "faults": out["monitor"].get("serving.faults", 0),
            "retries": out["monitor"].get("serving.retries", 0),
            "dumps": out["dumps"], "launches": out["launches"],
            "replay_launches": out["replays"], "draws": out["draws"],
            "graph_captures": out["counters"]["graph_captures"],
            "wall_s": out["wall_s"]}
    if bad:
        line["misses"] = bad
    log(json.dumps(line))
    if bad:
        raise AssertionError(f"5f {name}: {bad}")
    return line


def tele_parity(torch, qm, dev, card, cfg, params, per_pass, spec_tick,
                tmp, engine):
    """5f (a): one workload of mixed-length prompts (8 requests on 8
    slots, two sampled) through each of TELE_ENGINES with telemetry off
    and on: the streams equal to the bit run for run, one pull a prefill
    and a dispatch either way, the same captures and replays, the
    tokens field plus the prefills the emitted tokens (the spec row's
    tokens count what the device advanced, a finish mid-block dropping
    the rest, so there at least those), `attended` as the host works it
    out, `poisoned` 0. The dense K = 1 tick and the K = 4 dispatch are
    timed off and on in mirrored order (the median over every dispatch
    of the 4 runs; a capture lands in one)."""
    prompts = chaos_prompts(cfg.vocab_size, 8, seed=21)
    drive = submit_all(prompts, TELE_SAMPLED)
    lines = {}
    launches = replays = 0
    for label, kw, order in TELE_ENGINES:
        per_tick = spec_tick if kw.get("spec_decode") else per_pass
        engs = {t: engine(num_slots=8, telemetry=t, **kw)
                for t in ("off", "on")}
        runs = {"off": [], "on": []}
        for t in order:
            out = chaos_run(torch, qm, dev, engs[t], drive,
                            f"5f_{label}_{t}", per_pass, per_tick,
                            detail=True)
            runs[t].append(out)
            launches += out["launches"]
            replays += out["replays"]
        bad = []
        for a, b in zip(runs["off"], runs["on"]):
            if a["streams"] != b["streams"]:
                bad.append("streams differ off/on")
            for o in (a, b):
                c = o["counters"]
                if o["pulls"] != c["prefills"] + c["decode_ticks"]:
                    bad.append(f"{o['pulls']} pulls != {c['prefills']} "
                               f"prefills + {c['decode_ticks']} dispatches")
            for k in ("graph_captures", "graph_replays", "decode_ticks"):
                if a["counters"][k] != b["counters"][k]:
                    bad.append(f"{k} {a['counters'][k]} off vs "
                               f"{b['counters'][k]} on")
            if a["ticks"]:
                bad.append("telemetry off wrote tick records")
            ticks = b["ticks"]
            emitted = b["counters"]["tokens_emitted"]
            field = sum(r["tokens"] for r in ticks) + \
                b["counters"]["prefills"]
            if (field < emitted) if engs["on"].spec else (field != emitted):
                bad.append(f"tokens field + prefills {field} vs "
                           f"{emitted} emitted")
            if [r["attended"] for r in ticks] != b["attended"]:
                bad.append(f"attended {[r['attended'] for r in ticks][:4]} "
                           f"vs the host's {b['attended'][:4]}")
            if any(r["poisoned"] for r in ticks) or len(ticks) != \
                    b["counters"]["decode_ticks"]:
                bad.append("poisoned rows, or a record missing")
        line = {"phase": "gpt_serving_chaos", "part": "telemetry_parity",
                "engine": label, "card": card, "knobs": kw, "ok": not bad,
                "runs": len(order),
                "dispatches": runs["on"][0]["counters"]["decode_ticks"],
                "pulls": runs["on"][0]["pulls"],
                "graph_captures": runs["on"][0]["counters"][
                    "graph_captures"],
                "graph_replays": runs["on"][0]["counters"]["graph_replays"]}
        if len(order) > 2:
            off = [ms for o in runs["off"] for ms in o["tick_ms"]]
            on = [ms for o in runs["on"] for ms in o["tick_ms"]]
            line.update({"tick_ms_p50_off": statistics.median(off),
                         "tick_ms_p50_on": statistics.median(on),
                         "tick_ms_p50_delta": statistics.median(on)
                         - statistics.median(off),
                         "tick_ms": "per dispatch (K ticks)"
                         if engs["on"].mt_k > 1 else "per tick"})
        if bad:
            line["misses"] = bad
        log(json.dumps(line))
        if bad:
            raise AssertionError(f"5f (a) {label}: {bad}")
        lines[label] = line
        del engs
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return lines, launches, replays


def gpt_serving_chaos(torch, qm, dev, card, cfg, params):
    """Phase 5f: phase 5's GPT (FULL, seed 0, its int8 rewrite) serving
    under the reference's engine fault kinds (tools/chaos_serving.py
    :442-783, the router's scenario aside), telemetry, tracing and SLO
    records on: (a) `tele_parity`; (b) each scenario against the
    fault-free run of its engine and drive (`chaos_check`), on the dense
    K = 1 engine, the K = 4 graphed one, the paged one and a spec one
    with full-depth drafts; (c) one request's span tree on the paged
    engine with chunked prefill, a chrome export that loads, and a
    BurnRateMonitor fed the nan_logits run's SLO record and poisoned
    count raising its alert; (d) through `chaos_run`, every run's int8
    and threefry launches. Returns (the int8 kernel's launches through
    the wrapper, {"replays": launches inside graph replays})."""
    import tempfile

    from paddle_tpu_torch.inference import ServingEngine
    from paddle_tpu_torch.inference.serving import BackpressureError
    from paddle_tpu_torch.profiler import flight_recorder, tracing
    from paddle_tpu_torch.profiler.slo import BurnRateMonitor, Objective
    per_pass = sum(pass_calls(LEAF_KN, cfg.num_layers).values())
    # full-depth drafts: a greedy draft the verify accepts, so a
    # poisoned draft lane shows as a lost acceptance
    spec_kw = dict(spec_decode="spec", gamma=2, draft_layers=cfg.num_layers)
    spec_full = per_pass + spec_kw["gamma"] * per_pass
    spec_two = per_pass + 4 * sum(pass_calls(LEAF_KN, 2).values())
    parts = {}

    def engine(num_slots=CHAOS_SLOTS, **kw):
        kw.setdefault("tracing", True)
        return ServingEngine(params, cfg, family="gpt", num_slots=num_slots,
                             max_len=1024, max_top_k=50, seed=0,
                             quant="int8", device=dev, **kw)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_5f_")
    old_flight = flight_recorder.recorder().dir
    try:
        t0 = time.perf_counter()
        tele, launches, replays = tele_parity(
            torch, qm, dev, card, cfg, params, per_pass, spec_two, tmp,
            engine)
        parts["a"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        prompts6 = chaos_prompts(cfg.vocab_size, CHAOS_K4_REQUESTS, seed=31)
        prompts = prompts6[:CHAOS_SLOTS]
        drive = submit_all(prompts, CHAOS_SAMPLED)
        drive6 = submit_all(prompts6, CHAOS_SAMPLED, n=CHAOS_NEW_LONG)
        drive_s = submit_all(prompts, CHAOS_SAMPLED, n=CHAOS_NEW_LONG)
        n_req = len(prompts)
        scen = {}

        def run(label, eng, spec=None, per_tick=per_pass, drv=drive):
            nonlocal launches, replays
            out = chaos_run(torch, qm, dev, eng, drv, f"5f_{label}",
                            per_pass, per_tick, spec=spec,
                            sdir=os.path.join(tmp, label))
            launches += out["launches"]
            replays += out["replays"]
            return out

        def scenario(name, eng, spec, base, per_tick=per_pass, drv=drive,
                     **checks):
            out = run(name, eng, spec, per_tick, drv)
            scen[name] = chaos_check(name, out, base, **checks)
            return out

        # the dense K = 1 engine
        base = run("clean_dense", engine())
        nan_eng = engine()
        nan = scenario("nan_logits@2:1", nan_eng, "nan_logits@2:1", base,
                       monitor={"serving.poisoned": 1, "serving.faults": 1},
                       dump="serving_poisoned_fault")
        if nan["reasons"].count("poisoned") != 1 or \
                not nan["monitor"].get("serving.quant_matmuls"):
            raise AssertionError(f"5f nan_logits: {nan['reasons']}")
        # every engine here is int8: the reference's quant_nan_logits
        scen["nan_logits@2:1"]["also"] = "quant_nan_logits@2:1"
        scenario("tick_stall@2:400", engine(
            watchdog_timeout=0.2, retries=3, backoff_base=0.2),
            "tick_stall@2:400", base, reasons=["length"] * n_req,
            at_least={"serving.retries": 1}, monitor={"serving.faults": 0},
            dump="serving_stall")
        for kind in ("prefill_raise@0", "decode_raise@2"):
            scenario(kind, engine(), kind, base, reasons=["length"] * n_req,
                     monitor={"serving.faults": 1, "serving.retries": 1},
                     dump=f"serving_{kind.split('_')[0]}_fault")
        oom = scenario("oom@2", engine(), "oom@2", base,
                       reasons=["length"] * n_req,
                       monitor={"serving.oom_forensics": 1,
                                "serving.faults": 1, "serving.retries": 1},
                       dump="oom_forensics")
        doc = [flight_recorder.load_dump(os.path.join(tmp, "oom@2",
                                                      "flight", f))
               for f in os.listdir(os.path.join(tmp, "oom@2", "flight"))
               if "oom_forensics" in f][0]["config"]["oom_forensics"]
        if not (doc["census"] and doc["ledger"]["components"]
                and doc["ledger"]["total"] and doc["live_bytes"] > 0):
            raise AssertionError(f"5f oom_forensics dump: {doc.keys()}")

        def flood(eng):
            accepted, rejected = [], 0
            for i, p in enumerate(prompts):
                try:
                    accepted.append(eng.submit(p, CHAOS_NEW, temperature=(
                        CHAOS_SAMPLED.get(i, (0.0, 0))[0]),
                        top_k=CHAOS_SAMPLED.get(i, (0.0, 0))[1]))
                except BackpressureError as e:
                    rejected += 1
                    if e.queue_depth != 2:
                        raise AssertionError(f"rejected at depth "
                                             f"{e.queue_depth}")
            while eng.has_work():
                eng.step()
            return accepted
        scenario("queue_flood_reject", engine(max_queue=2), None, base,
                 drv=flood, monitor={"serving.rejected": n_req - 2},
                 reasons=["length"] * 2)
        scenario("queue_flood_shed", engine(max_queue=2,
                                            queue_policy="shed_oldest"),
                 None, base, monitor={"serving.evicted": n_req - 2},
                 reasons=["evicted"] * (n_req - 2) + ["length"] * 2)

        def cancel_deadline(eng):
            reqs = [eng.submit(p, CHAOS_NEW,
                               temperature=CHAOS_SAMPLED.get(i, (0.0, 0))[0],
                               top_k=CHAOS_SAMPLED.get(i, (0.0, 0))[1],
                               deadline_ticks=3 if i == 2 else None)
                    for i, p in enumerate(prompts)]
            eng.step()
            eng.step()
            victim = reqs[0]
            if not victim.cancel():
                raise AssertionError("cancel() refused a live request")
            while eng.has_work():
                eng.step()
            return reqs
        cd = scenario("cancel_deadline", engine(), None, base,
                      drv=cancel_deadline,
                      monitor={"serving.cancelled": 1,
                               "serving.timeout": 1})
        if cd["reasons"][0] != "cancelled" or \
                cd["reasons"][2] != "timeout":
            raise AssertionError(f"5f cancel_deadline: {cd['reasons']}")

        # the K = 4 engine, a CUDA graph replay a dispatch
        # (6 requests: 2 wait, and survive the hard reset in the queue)
        base4 = run("clean_k4", engine(multi_tick=CHAOS_K), drv=drive6)
        scenario("nan_logits@2:1_k4", engine(multi_tick=CHAOS_K),
                 "nan_logits@2:1", base4, drv=drive6,
                 monitor={"serving.poisoned": 1, "serving.faults": 1},
                 dump="serving_poisoned_fault")
        scenario("tick_stall@2:400_k4", engine(
            multi_tick=CHAOS_K, watchdog_timeout=0.2, retries=3,
            backoff_base=0.2), "tick_stall@2:400", base4, drv=drive6,
            reasons=["length"] * CHAOS_K4_REQUESTS,
            at_least={"serving.retries": 1}, dump="serving_stall")
        eng = engine(multi_tick=CHAOS_K, retries=0)
        reset = scenario("decode_raise@2_k4_hard_reset", eng,
                         "decode_raise@2", base4, drv=drive6,
                         captures=False,
                         monitor={"serving.faults": 1,
                                  "serving.evicted": CHAOS_SLOTS},
                         dump="serving_hard_reset")
        if reset["reasons"] != ["evicted"] * CHAOS_SLOTS + \
                ["length"] * (CHAOS_K4_REQUESTS - CHAOS_SLOTS):
            raise AssertionError(f"5f hard reset: {reset['reasons']}")
        # fresh requests after the reset: the greedy ones of the clean
        # run stream its tokens (a sampled stream keys on its request id)
        greedy = [i for i in range(CHAOS_SLOTS) if i not in CHAOS_SAMPLED]
        fresh = run("after_hard_reset", eng, drv=submit_all(
            [prompts6[i] for i in greedy], {}, n=CHAOS_NEW_LONG))
        if fresh["streams"] != [base4["streams"][i] for i in greedy]:
            raise AssertionError("5f: fresh streams after the hard reset "
                                 "differ from the clean run's")
        scen["decode_raise@2_k4_hard_reset"]["fresh_equal"] = len(greedy)
        scen["decode_raise@2_k4_hard_reset"]["graph_captures_all"] = \
            eng.counters["graph_captures"]
        del eng

        # the paged engine
        base_p = run("clean_paged", engine(**CHAOS_PAGED))
        scenario("paged_nan_poison@2:1", engine(**CHAOS_PAGED),
                 "nan_logits@2:1", base_p, monitor={"serving.poisoned": 1},
                 dump="serving_poisoned_fault")
        eng = engine(num_pages=25, **CHAOS_PAGED)
        scenario("paged_pool_flood", eng, None, base_p,
                 reasons=["length"] * n_req)
        st = eng.pool_stats()
        if st["pages_in_use"] or st["pages_reserved"]:
            raise AssertionError(f"5f pool flood leaked: {st}")
        aligned = chaos_prompts(cfg.vocab_size, 1, seed=99, lo=64, hi=64)[0]

        def cow(eng):
            donor = eng.submit(aligned, CHAOS_NEW)
            while eng.has_work():
                eng.step()
            sharer = eng.submit(aligned, CHAOS_NEW)
            while eng.has_work():
                eng.step()
            return [donor, sharer]
        base_c = run("clean_cow", engine(**CHAOS_PAGED), drv=cow)
        eng = engine(**CHAOS_PAGED)
        scenario("cow_raise@0", eng, "cow_raise@0", base_c, drv=cow,
                 reasons=["length", "length"],
                 monitor={"serving.faults": 1, "serving.retries": 1},
                 dump="serving_prefill_fault")
        if eng.pool_stats()["pages_reserved"] or \
                base_c["counters"]["cow_copies"] < 1:
            raise AssertionError(f"5f cow: {eng.pool_stats()}")
        del eng

        # speculative decode, full-depth drafts
        base_s = run("clean_spec", engine(**spec_kw), per_tick=spec_full,
                     drv=drive_s)
        draft = scenario("spec_draft_nan@2:1", engine(**spec_kw),
                         "draft_nan@2:1", base_s, per_tick=spec_full,
                         drv=drive_s,
                         reasons=["length"] * n_req,
                         monitor={"serving.poisoned": 0})
        # the poisoned tick's row: fewer drafts kept than the clean run's
        # same tick (a full-depth draft the verify keeps)
        acc, acc0 = ([r["spec_accepted"] for r in o["ticks"]
                      if r["tick"] == 2] for o in (draft, base_s))
        if not acc[0] < acc0[0]:
            raise AssertionError(f"5f draft_nan: tick 2 kept {acc} drafts, "
                                 f"the clean run {acc0}: the fault never "
                                 "bit")
        scen["spec_draft_nan@2:1"]["tick2_spec_accepted"] = [acc[0],
                                                             acc0[0]]
        scenario("spec_nan_logits@2:1", engine(**spec_kw),
                 "nan_logits@2:1", base_s, per_tick=spec_full, drv=drive_s,
                 monitor={"serving.poisoned": 1},
                 dump="serving_poisoned_fault")
        parts["b"] = time.perf_counter() - t0

        # (c) one request's span tree; the SLO alert of the nan run
        t0 = time.perf_counter()
        tracing.clear()
        eng = engine(prefix_sharing=False, prefill_chunk=CHAOS_CHUNK,
                     **CHAOS_PAGED)
        req = eng.submit(chaos_prompts(cfg.vocab_size, 1, seed=41, lo=200,
                                       hi=200)[0], CHAOS_NEW)
        while eng.has_work():
            eng.step()
        tr = tracing.tracer()
        spans = sorted(tr.spans(req.trace.trace_id),
                       key=lambda s: s.span_id)
        root = [s for s in spans if s.name == f"request-{req.id}"][0]
        by = collections.defaultdict(list)
        for s in spans:
            by[s.name].append(s)
        dec = by["decode"][0].span_id if by["decode"] else None
        terms = tr.terminal_spans(req.trace.trace_id)
        path = os.path.join(tmp, "trace.json")
        tr.export_chrome_trace(path)
        with open(path) as f:
            evs = json.load(f)["traceEvents"]
        tree_ok = (req.finish_reason == "length" and root.parent_id is None
                   and len(by["queue"]) == 1 and len(by["prefill"]) >= 2
                   and len(by["decode"]) == 1
                   and all(s.parent_id == root.span_id
                           for n in ("queue", "prefill", "decode")
                           for s in by[n])
                   and len(by["decode.tick"]) == CHAOS_NEW
                   and all(s.parent_id == dec for s in by["decode.tick"])
                   and len(terms) == 1
                   and terms[0].attrs["reason"] == "length"
                   and any(e.get("cat") == "terminal" for e in evs))
        # the nan_logits run's SLO record and its poisoned finish
        slo_path = os.path.join(tmp, "slo.jsonl")
        nan_eng.export_slo_jsonl(slo_path)
        mon = BurnRateMonitor(
            [Objective("poisoned", "errors", "event", budget=0.01),
             Objective("ttft", "ttft", "latency", threshold_ms=60e3,
                       budget=0.01)], pairs=((300.0, 30.0),))
        with open(slo_path) as f:
            for line in f:
                rec = json.loads(line)
                if rec.get("kind") == "serving_slo":
                    mon.feed_slo_record(rec)
        mon.observe_events("errors",
                           bad=nan["monitor"].get("serving.poisoned", 0),
                           total=nan["monitor"].get(
                               "serving.requests_completed", 0))
        fdir = os.path.join(tmp, "slo_alert")
        os.makedirs(fdir, exist_ok=True)
        flight_recorder.recorder().set_dir(fdir)
        try:
            alerts = [a.objective for a in mon.check()]
        finally:
            flight_recorder.recorder().set_dir(None)
        alert_dumps = [flight_recorder.load_dump(os.path.join(fdir, f))[
            "reason"] for f in os.listdir(fdir)]
        line = {"phase": "gpt_serving_chaos", "part": "tracing_slo",
                "ok": tree_ok and alerts == ["poisoned"]
                and "slo_burn_alert" in alert_dumps,
                "prefill_spans": len(by["prefill"]),
                "decode_ticks": len(by["decode.tick"]),
                "terminal": [t.attrs["reason"] for t in terms],
                "chrome_events": len(evs), "alerts": alerts,
                "burn_rates": mon.burn_rates(), "dumps": alert_dumps}
        log(json.dumps(line))
        if not line["ok"]:
            raise AssertionError(f"5f (c): {line}")
        del eng, nan_eng
        parts["c"] = time.perf_counter() - t0
    finally:
        flight_recorder.recorder().set_dir(old_flight)
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)
    log(json.dumps({"phase": "gpt_serving_chaos", "card": card,
                    "scenarios": len(scen), "seconds_by_part": parts,
                    "launches": launches, "replay_launches": replays,
                    "telemetry": {k: {m: v for m, v in ln.items()
                                      if m.startswith("tick_ms")}
                                  for k, ln in tele.items()}}))
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return launches, {"replays": replays}


# phase 5g: the serving fleet over phase 5's GPT (its weights and int8
# rewrite): routers of int8 replicas through replica death with live
# migration, drain and autoscale, prefill/decode roles, tenant quotas, the
# brownout ladder, a host spill flood and a SIGKILLed process replayed
# from its journal
FLEET_SLOTS = 4                 # every replica's slots
FLEET_NEW = 8                   # new tokens a request
FLEET_NEW_LONG = 12             # the K = 4 and brownout scenarios'
FLEET_SPILL_NEW = 4             # host_spill_flood's (its pool is the point)
FLEET_REQUESTS = 8
FLEET_SAMPLED = {3: (0.8, 40)}  # live migration's sampled request
FLEET_PAGED = dict(kv_layout="paged", page_size=16)
FLEET_K = 4
# the crash child's sigkill tick: its first wave (4 slots of 8) has
# finished, the second is mid-decode
FLEET_CRASH_KILL = FLEET_NEW + 2
# a router tick's ms, serial and concurrent, in mirrored order
FLEET_TIMED = (False, True, True, False)
# the draws and int8 launches of the run in progress (`fleet_engine`'s
# dispatch wrapper adds to it; `fleet_run` zeroes and reads it)
FLEET_TALLY = {}


def fleet_prompts(vocab):
    return chaos_prompts(vocab, FLEET_REQUESTS, seed=51)


def fleet_engine(params, cfg, dev, per_pass, made, num_slots=FLEET_SLOTS,
                 **kw):
    """An int8 replica of phase 5g (FLEET_SLOTS slots, max_len 1024), its
    dispatches tallied into FLEET_TALLY: the int8 and threefry launches
    an eager dispatch makes through the wrappers (K ticks of its tick's
    calls; under multi-tick only each graph's warm-up), and the ones a
    graph replay runs, by the tick body live at the dispatch (spec on or
    off: `set_spec_drafts` flips it)."""
    from paddle_tpu_torch.inference import ServingEngine
    eng = ServingEngine(params, cfg, family="gpt", num_slots=num_slots,
                        max_len=1024, max_top_k=50, seed=0, quant="int8",
                        device=dev, **kw)
    dispatch = eng._dispatch
    draft = sum(pass_calls(LEAF_KN, eng.spec_draft_layers).values())

    def tallied(sampling):
        tick = per_pass + (eng.spec_gamma * draft if eng.spec else 0)
        replay = eng.mt_k > 1 and eng._graphed and sampling in eng._graphs
        key = "replay" if replay else "eager"
        FLEET_TALLY[key] = FLEET_TALLY.get(key, 0) + eng.mt_k * tick
        if sampling:
            FLEET_TALLY[key + "_draws"] = FLEET_TALLY.get(
                key + "_draws", 0) + eng.mt_k
        if eng.mt_k > 1 and not replay:
            FLEET_TALLY["captured"] = FLEET_TALLY.get("captured", 0) + \
                eng.mt_k * tick
            FLEET_TALLY["captured_draws"] = FLEET_TALLY.get(
                "captured_draws", 0) + eng.mt_k * bool(sampling)
        return dispatch(sampling)
    eng._dispatch = tallied
    made.append(eng)
    return eng


def fleet_run(torch, qm, dev, label, make, drive, per_pass, made, sdir,
              spec=None):
    """One router run of phase 5g: `make()` builds the router (its
    engines through `fleet_engine`, into `made`), then the flight
    recorder points at sdir/label/flight, the fault `spec` installs with
    a once-dir of its own, the kernels' counts and FLEET_TALLY zero, and
    `drive(router)` runs (it may spawn more engines). Holds the int8
    kernel's launches through the wrapper to the prefill passes and the
    eager dispatches, its launches recorded under capture to the
    captures, the engines' `serving.quant_matmuls` to the wrapper's plus
    the replays', the threefry kernel's to the sampled passes and
    dispatches (adding them to DRAWS), and every outer request to one
    terminal reason and one terminal span. Returns the run's record."""
    from paddle_tpu_torch.inference import TERMINAL_REASONS
    from paddle_tpu_torch.kernels import threefry as tf
    from paddle_tpu_torch.profiler import flight_recorder, tracing
    from paddle_tpu_torch.testing import faults
    rec = flight_recorder.recorder()
    fdir = os.path.join(sdir, label, "flight")
    os.makedirs(fdir, exist_ok=True)
    n_made = len(made)
    router = make()
    rec.clear()
    rec.set_dir(fdir)
    tracing.clear()
    mine = made[n_made:]
    c0 = {id(e): dict(e.counters) for e in mine}
    m0 = serving_counters()
    cuda_sync(torch, dev)
    FLEET_TALLY.clear()
    qm.launches = 0                          # the main path starts here
    cap0 = qm.captured
    tf.launches["threefry_bits"] = 0
    tf_cap0 = tf.captured
    if spec:
        faults.install(spec, once_dir=os.path.join(sdir, label, "once"))
    t0 = time.perf_counter()
    try:
        reqs = drive(router)
        cuda_sync(torch, dev)
    finally:
        if spec:
            faults.uninstall()
        rec.set_dir(None)
    wall = time.perf_counter() - t0
    launches = qm.launches                   # ... and ends here
    draws = tf.launches["threefry_bits"]
    mine = made[n_made:]
    zero = dict.fromkeys(mine[0].counters, 0)
    c = {k: sum(e.counters[k] - c0.get(id(e), zero)[k] for e in mine)
         for k in zero}
    passes = sum(e.counters[k] - c0.get(id(e), zero)[k] for e in mine
                 for k in (("prefill_chunks",) if e.paged
                           else ("prefills",)))
    m = {k: v - m0.get(k, 0) for k, v in serving_counters().items()
         if v - m0.get(k, 0)}
    t = FLEET_TALLY
    bad = []
    if launches != per_pass * passes + t.get("eager", 0):
        bad.append(f"int8 launches {launches} != {per_pass} x {passes} "
                   f"passes + {t.get('eager', 0)} in eager dispatches")
    if qm.captured - cap0 != t.get("captured", 0):
        bad.append(f"{qm.captured - cap0} int8 launches captured != "
                   f"{t.get('captured', 0)}")
    if m.get("serving.quant_matmuls", 0) != c["quant_matmuls"] or \
            c["quant_matmuls"] != launches + t.get("replay", 0):
        bad.append(f"serving.quant_matmuls {m.get('serving.quant_matmuls')}"
                   f", the engines' {c['quant_matmuls']}, the wrapper's "
                   f"{launches} + {t.get('replay', 0)} in replays")
    if draws != c["sampled_passes"] + t.get("eager_draws", 0) or \
            tf.captured - tf_cap0 != t.get("captured_draws", 0):
        bad.append(f"threefry launches {draws} != {c['sampled_passes']} "
                   f"sampled passes + {t.get('eager_draws', 0)}, or "
                   f"{tf.captured - tf_cap0} captured != "
                   f"{t.get('captured_draws', 0)}")
    tr = tracing.tracer()
    for r in reqs:
        terms = tr.terminal_spans(r.trace.trace_id)
        if (not r.done or r.finish_reason not in TERMINAL_REASONS
                or r.slot is not None or len(terms) != 1
                or terms[0].attrs["reason"] != r.finish_reason):
            bad.append(f"request {r.id} done={r.done} reason="
                       f"{r.finish_reason} slot={r.slot}, {len(terms)} "
                       "terminal spans")
    if bad:
        raise AssertionError(f"5g {label}: {bad}")
    DRAWS["launches"] += draws
    DRAWS["captured"] += tf.captured - tf_cap0
    DRAWS["replayed"] += t.get("replay_draws", 0)
    dumps = sorted(flight_recorder.load_dump(os.path.join(fdir, f))[
        "reason"] for f in os.listdir(fdir))
    return {"router": router, "reqs": reqs,
            "streams": [list(map(int, r.tokens)) for r in reqs],
            "reasons": [r.finish_reason for r in reqs],
            "requeues": [r.requeues for r in reqs], "counters": c,
            "monitor": m, "launches": launches,
            "replays": t.get("replay", 0), "draws": draws, "dumps": dumps,
            "fdir": fdir, "wall_s": wall}


def fleet_check(name, out, base, reasons=None, monitor=None,
                at_least=None, dumps=(), extra=None):
    """A scenario's three invariants against `base`, the streams of an
    undisturbed run of the same layout: every request ended in one
    terminal reason and span (`fleet_run`); the finished streams equal
    the base's to the bit, the others are prefixes; each of `dumps` is a
    flight dump's reason. Then the serving.* counters: `monitor` exact
    deltas, `at_least` lower bounds, and the reasons where given. Prints
    the scenario's line and returns it."""
    bad = []
    for i, (got, want, why) in enumerate(zip(out["streams"], base,
                                             out["reasons"])):
        ok = (got == want if why in ("length", "eos")
              else got == want[:len(got)])
        if not ok:
            bad.append(f"request {i} ({why}) {got[:6]} vs {want[:6]}")
    if reasons is not None and out["reasons"] != reasons:
        bad.append(f"reasons {out['reasons']} != {reasons}")
    for k, v in (monitor or {}).items():
        if out["monitor"].get(k, 0) != v:
            bad.append(f"{k} moved {out['monitor'].get(k, 0)} != {v}")
    for k, v in (at_least or {}).items():
        if out["monitor"].get(k, 0) < v:
            bad.append(f"{k} moved {out['monitor'].get(k, 0)} < {v}")
    for d in dumps:
        if d not in out["dumps"]:
            bad.append(f"no {d!r} flight dump in {out['dumps']}")
    line = {"phase": "gpt_fleet", "scenario": name, "ok": not bad,
            "reasons": out["reasons"], "requeues": out["requeues"],
            "router": {k[len("serving.router."):]: v
                       for k, v in out["monitor"].items()
                       if k.startswith("serving.router.")},
            "autoscale": {k[len("serving.autoscale."):]: v
                          for k, v in out["monitor"].items()
                          if k.startswith("serving.autoscale.")},
            "other": {k: v for k, v in out["monitor"].items()
                      if k.startswith(("serving.brownout",
                                       "serving.admission",
                                       "serving.journal"))},
            "dumps": out["dumps"], "launches": out["launches"],
            "replay_launches": out["replays"], "draws": out["draws"],
            "wall_s": out["wall_s"], **(extra or {})}
    if bad:
        line["misses"] = bad
    log(json.dumps(line))
    if bad:
        raise AssertionError(f"5g {name}: {bad}")
    return line


def fleet_crash_child(workdir):
    """Phase 5g's process_crash_replay child, started by the phase in the
    background: a journaled router over one int8 replica (the tree the
    phase saved), the phase's greedy workload, and `sigkill` at router
    tick FLEET_CRASH_KILL; it dies there, and its fsynced journal is all
    that is left."""
    bind_to_script()
    import torch
    sys.path.insert(0, HERE)
    from paddle_tpu_torch.inference import EngineRouter, ServingEngine
    from paddle_tpu_torch.models.gpt import GPTConfig
    from paddle_tpu_torch.quantization import serving as qs
    from paddle_tpu_torch.testing import faults
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tree = torch.load(os.path.join(workdir, "int8.pt"), mmap=True,
                      weights_only=False)
    qs.quantize_serving_params = lambda params, family: tree
    cfg = GPTConfig(**FULL)
    eng = ServingEngine({}, cfg, family="gpt", num_slots=FLEET_SLOTS,
                        max_len=1024, max_top_k=50, seed=0, quant="int8")
    faults.install(f"sigkill@{FLEET_CRASH_KILL}",
                   once_dir=os.path.join(workdir, "once"))
    router = EngineRouter([eng], concurrent=False,
                          journal_dir=os.path.join(workdir, "journal"))
    for p in fleet_prompts(cfg.vocab_size):
        router.submit(p, FLEET_NEW)
    print(f"[chip_smoke] fleet crash child: first tick at "
          f"{time.time() - T_IMPORT:.1f} s", file=sys.stderr, flush=True)
    router.drain(max_ticks=400)
    print("[chip_smoke] fleet crash child outlived its sigkill",
          file=sys.stderr, flush=True)
    return 3


def gpt_fleet(torch, qm, dev, card, cfg, params):
    """Phase 5g: phase 5's GPT (FULL, seed 0, its int8 rewrite) served by
    routers of int8 replicas alike (FLEET_SLOTS slots, the same layout in
    a scenario), under the fleet scenarios of tools/chaos_serving.py
    :695-1170, each held to the three invariants against an undisturbed
    run of its layout (`fleet_check`), its kernels through `fleet_run`:
    router_replica_death (replica_preempt@3:0 on 2 full replicas: the
    requeue-replay path, and the burn alert); live migration on dense
    replicas (a sampled request among them, held to an undisturbed
    router), paged ones and K = 4 graphed ones (zero re-prefill, no
    fallback, no new capture in the survivor); migrate_raise's fallback;
    autoscale_flood; prefill_role_death; tenant_flood (quota_flood@2:6);
    brownout_ladder (0 -> 3 -> 0 over a spec K = 4 replica whose drafts
    flip); host_spill_flood; process_crash_replay (a child started at
    the phase's start, SIGKILLed mid-run, its journal replayed here). Then
    a router tick's ms serial and concurrent, alternated, and on K = 4
    replicas stepped on threads. Returns (the int8 kernel's launches
    through the wrapper, {"replays": launches inside graph replays})."""
    import shutil
    import signal
    import subprocess
    import tempfile

    from paddle_tpu_torch.inference import (AutoscaleConfig, Autoscaler,
                                            BrownoutConfig,
                                            BrownoutController, EngineRouter,
                                            QuotaExceededError, TenantQuota)
    from paddle_tpu_torch.inference.journal import RequestJournal
    from paddle_tpu_torch.profiler import flight_recorder
    from paddle_tpu_torch.profiler.slo import BurnRateMonitor, Objective
    from paddle_tpu_torch.quantization import serving as qs
    per_pass = sum(pass_calls(LEAF_KN, cfg.num_layers).values())
    prompts = fleet_prompts(cfg.vocab_size)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_5g_")
    old_flight = flight_recorder.recorder().dir
    made, scen, parts = [], {}, {}
    launches = replays = 0
    t_phase = time.perf_counter()
    child = None
    try:
        # the crash child first: a fresh process takes ~30 s to its
        # first step, which the scenarios below overlap
        cdir = os.path.join(tmp, "crash")
        os.makedirs(cdir)
        t0 = time.perf_counter()
        torch.save(qs.quantize_serving_params(params, "gpt"),
                   os.path.join(cdir, "int8.pt"))   # quantize_once's
        env = dict(os.environ, PADDLE_TPU_FLIGHT_DIR=os.path.join(
            cdir, "flight"))
        errf = open(os.path.join(cdir, "stderr.txt"), "w")
        child = subprocess.Popen(
            [sys.executable, os.path.join(HERE, "chip_smoke.py"),
             "--fleet-crash-child", cdir], stdout=subprocess.DEVNULL,
            stderr=errf, env=env)
        parts["child_start"] = time.perf_counter() - t0

        def engine(**kw):
            return fleet_engine(params, cfg, dev, per_pass, made, **kw)

        def router(n=2, kw=None, **rkw):
            return EngineRouter([engine(**(kw or {})) for _ in range(n)],
                                tracing=True,
                                concurrent=rkw.pop("concurrent", False),
                                **rkw)

        def submit(r, n=FLEET_NEW, sampled=None, reqs=prompts, **kw):
            sampled = sampled or {}
            return [r.submit(p, n, temperature=sampled.get(i, (0.0, 0))[0],
                             top_k=sampled.get(i, (0.0, 0))[1], **kw)
                    for i, p in enumerate(reqs)]

        def run(name, make, drive, spec=None):
            nonlocal launches, replays
            out = fleet_run(torch, qm, dev, name, make, drive, per_pass,
                            made, tmp, spec=spec)
            launches += out["launches"]
            replays += out["replays"]
            return out

        def drained(n=FLEET_NEW, sampled=None, reqs=prompts):
            def drive(r):
                out = submit(r, n, sampled, reqs)
                r.drain()
                return out
            return drive

        def release():
            del made[:]
            gc.collect()
            torch.cuda.empty_cache()

        # the undisturbed runs: one replica a layout, greedy
        t0 = time.perf_counter()
        base = run("base_dense", lambda: router(1), drained())["streams"]
        base_p = run("base_paged", lambda: router(1, FLEET_PAGED),
                     drained())["streams"]
        base_k = run("base_k4", lambda: router(1, dict(multi_tick=FLEET_K)),
                     drained(FLEET_NEW_LONG))["streams"]
        release()
        parts["base"] = time.perf_counter() - t0

        # router_replica_death: both replicas full, so the survivor has
        # no free slot and the dead one's streams replay from scratch
        t0 = time.perf_counter()
        out = run("router_replica_death", lambda: router(2), drained(),
                  spec="replica_preempt@3:0")
        fleet_check("router_replica_death", out, base,
                    reasons=["length"] * FLEET_REQUESTS,
                    monitor={"serving.router.replica_deaths": 1,
                             "serving.autoscale.migrations": 0},
                    at_least={"serving.router.requeues": 1},
                    dumps=["router_replica_death"])
        requeued = out["monitor"]["serving.router.requeues"]
        mon = BurnRateMonitor(
            [Objective("requeues_rate", "requeues", "event", budget=0.001)],
            pairs=((60.0, 5.0),), cooldown_s=0.0)
        mon.observe_events("requeues", bad=requeued, total=FLEET_REQUESTS)
        flight_recorder.recorder().set_dir(out["fdir"])
        try:
            alerts = [a.objective for a in mon.check()]
        finally:
            flight_recorder.recorder().set_dir(None)
        alert_dumps = [flight_recorder.load_dump(os.path.join(
            out["fdir"], f))["reason"] for f in os.listdir(out["fdir"])]
        if alerts != ["requeues_rate"] or \
                "slo_burn_alert" not in alert_dumps:
            raise AssertionError(f"5g replica death burn alert: {alerts}, "
                                 f"{alert_dumps}")
        scen["router_replica_death"] = {"requeued": requeued,
                                        "alerts": alerts}
        release()

        # live migration: 4 requests on 2 replicas, so the survivor has
        # room for every stream of the one that dies
        mig = {}

        def migrate(kill_after, n, sampled=None):
            def drive(r):
                reqs = submit(r, n, sampled, prompts[:4])
                for _ in range(kill_after):
                    r.step()
                victim = max(r.replicas, key=lambda rep: sum(
                    1 for o in rep.inner.values() if not o.done))
                survivor = r.replicas[1 - victim.idx].eng
                live = sum(1 for o in victim.inner.values() if not o.done)
                caps = survivor.counters.get("graph_captures", 0)
                snap, restore = victim.eng.snapshot_request, \
                    survivor.restore_request
                timing = {"kv_bytes": [], "snapshot_ms": [],
                          "restore_ms": []}

                def timed_snap(req):
                    cuda_sync(torch, dev)
                    t_s = time.perf_counter()
                    s = snap(req)
                    timing["snapshot_ms"].append(
                        (time.perf_counter() - t_s) * 1e3)
                    if s is not None:
                        timing["kv_bytes"].append(s["kv_bytes"])
                    return s

                def timed_restore(s, **kw):
                    cuda_sync(torch, dev)
                    t_s = time.perf_counter()
                    got = restore(s, **kw)
                    cuda_sync(torch, dev)
                    timing["restore_ms"].append(
                        (time.perf_counter() - t_s) * 1e3)
                    return got
                victim.eng.snapshot_request = timed_snap
                survivor.restore_request = timed_restore
                replayed = r.kill_replica(victim.idx)
                del victim.eng.snapshot_request, survivor.restore_request
                r.drain()
                mig.update(live=live, replayed=replayed,
                           survivor_captures=[
                               caps, survivor.counters["graph_captures"]],
                           **timing)
                return reqs
            return drive
        for layout, kw, n, kill_after, want in (
                ("dense", {}, FLEET_NEW, 3, base),
                ("paged", FLEET_PAGED, FLEET_NEW, 3, base_p),
                ("k4", dict(multi_tick=FLEET_K), FLEET_NEW_LONG, 1,
                 base_k)):
            sampled = FLEET_SAMPLED if layout == "dense" else None
            if sampled:
                # the sampled request's undisturbed stream: the same
                # router, the same placements and engine ids
                want = run("live_migration_clean", lambda: router(2),
                           drained(n, sampled, prompts[:4]))["streams"]
            out = run(f"live_migration_{layout}",
                      lambda kw=kw: router(2, kw),
                      migrate(kill_after, n, sampled))
            caps = mig["survivor_captures"]
            line = fleet_check(
                f"live_migration_{layout}", out, want,
                reasons=["length"] * 4,
                monitor={"serving.router.replica_deaths": 1,
                         "serving.autoscale.migrations": mig["live"],
                         "serving.autoscale.migrate_fallbacks": 0,
                         "serving.router.requeues": 0,
                         "serving.prefills": 4},
                dumps=["router_replica_death"],
                extra={"migrated": mig["live"],
                       "kv_bytes": mig["kv_bytes"],
                       "snapshot_ms": mig["snapshot_ms"],
                       "restore_ms": mig["restore_ms"],
                       "survivor_captures": caps})
            if mig["replayed"] or not mig["live"] or \
                    (layout == "k4" and caps[0] != caps[1]):
                raise AssertionError(f"5g live_migration_{layout}: "
                                     f"{mig}")
            scen[f"live_migration_{layout}"] = {
                k: line[k] for k in ("migrated", "kv_bytes", "snapshot_ms",
                                     "restore_ms", "survivor_captures")}
            release()

        # migrate_raise: the next migration fails once and the stream
        # replays from scratch, its tokens never duplicated
        out = run("migrate_raise", lambda: router(2),
                  drained(reqs=prompts[:4]),
                  spec="migrate_raise@2,replica_preempt@3:0")
        fleet_check("migrate_raise", out, base,
                    reasons=["length"] * 4,
                    at_least={"serving.autoscale.migrate_fallbacks": 1,
                              "serving.router.requeues": 1},
                    dumps=["router_replica_death"])
        if any(len(s) != FLEET_NEW for s in out["streams"]):
            raise AssertionError("5g migrate_raise: a replayed stream "
                                 "holds duplicated tokens")
        release()
        parts["death_and_migration"] = time.perf_counter() - t0

        # autoscale_flood: the flood scales out, the idle drains to min
        t0 = time.perf_counter()
        clock = [0.0]

        def autoscale(r):
            sc = Autoscaler(r, spawn=engine, cfg=AutoscaleConfig(
                min_replicas=1, max_replicas=3, breach_ticks=2,
                idle_ticks=3, cooldown_s=1.0), clock=lambda: clock[0])
            reqs = submit(r)
            peak = 1
            for _ in range(200):
                if not r.has_work():
                    break
                r.step()
                clock[0] += 2.0
                sc.tick()
                peak = max(peak, len(r.dispatchable()))
            for _ in range(30):
                if len(r.dispatchable()) == 1:
                    break
                r.step()
                clock[0] += 2.0
                sc.tick()
            scen["autoscale_flood"] = {"peak": peak,
                                       "end": len(r.dispatchable())}
            return reqs
        out = run("autoscale_flood",
                  lambda: router(1, clock=lambda: clock[0]), autoscale)
        fleet_check("autoscale_flood", out, base,
                    reasons=["length"] * FLEET_REQUESTS,
                    at_least={"serving.autoscale.scale_out": 1,
                              "serving.autoscale.scale_in": 1},
                    dumps=["autoscale_scale_out", "autoscale_scale_in"])
        if scen["autoscale_flood"]["peak"] < 2 or \
                scen["autoscale_flood"]["end"] != 1:
            raise AssertionError(f"5g autoscale: {scen['autoscale_flood']}")
        release()

        # prefill_role_death: handoffs through the migration seam, then
        # the prefill replica dies and the decode one serves everything
        def roles(r):
            reqs = submit(r, reqs=prompts[:4])
            for _ in range(60):
                r.step()
                if r.stats()["handoffs"]:
                    break
            r.kill_replica(0, reason="chaos")
            reqs += submit(r, reqs=prompts[4:])
            r.drain(max_ticks=400)
            return reqs
        out = run("prefill_role_death",
                  lambda: router(2, roles=["prefill", "decode"]), roles)
        fleet_check("prefill_role_death", out, base,
                    reasons=["length"] * FLEET_REQUESTS,
                    monitor={"serving.router.replica_deaths": 1},
                    at_least={"serving.router.handoffs": 1},
                    dumps=["router_replica_death"])
        release()

        # tenant_flood: the flood tenant's bucket covers one of its 6
        # injected requests; the paying streams are exact
        def tenant(r):
            reqs = submit(r)
            r.drain(max_ticks=400)
            try:
                r.submit([1, 2, 3], 4, tenant="flood", priority=-1)
            except QuotaExceededError as e:
                scen["tenant_flood"] = {"retry_after_s": e.retry_after_s}
            return reqs
        # (on a frozen clock: the bucket never refills)
        out = run("tenant_flood", lambda: router(1, clock=lambda: 0.0,
                                                 admission={
            "flood": TenantQuota(tokens_per_s=0.5, burst=7.0)}), tenant,
            spec="quota_flood@2:6")
        fleet_check("tenant_flood", out, base,
                    reasons=["length"] * FLEET_REQUESTS,
                    monitor={"serving.admission.rejected.flood": 6},
                    extra=scen.get("tenant_flood"))
        if not scen.get("tenant_flood", {}).get("retry_after_s", 0) > 0:
            raise AssertionError("5g tenant_flood: no retry_after_s")
        release()

        # brownout_ladder: 0 -> 3 -> 0 over one spec K = 4 replica (2-layer
        # drafts, which random weights seldom accept, so the streams still
        # decode when the drafts go off), two priority classes in flight
        bclock = [0.0]

        class _Slo:
            pairs = [(3600.0, 60.0)]
            objectives = [Objective("ttft", "ttft", "latency",
                                    threshold_ms=1.0, budget=0.01)]
            burn = 0.0

            def burn_rate(self, name, window, now=None):
                return self.burn

        def brownout(r):
            slo = _Slo()
            ctrl = BrownoutController(r, slo=slo, cfg=BrownoutConfig(
                breach_ticks=2, recover_ticks=2, cooldown_s=0.0),
                clock=lambda: bclock[0])
            reqs = [r.submit(p, FLEET_NEW_LONG, priority=i % 2)
                    for i, p in enumerate(prompts)]
            levels = []
            for burn in (2.0, 0.0):
                slo.burn = burn
                for _ in range(8):
                    r.step()
                    bclock[0] += 1.0
                    ctrl.tick()
                    levels.append(ctrl.level)
            r.drain(max_ticks=400)
            eng = r.replicas[0].eng
            scen["brownout_ladder"] = {"levels": levels,
                                       "graph_captures":
                                       eng.counters["graph_captures"],
                                       "spec": eng.spec}
            return reqs
        out = run("brownout_ladder", lambda: router(
            1, dict(multi_tick=FLEET_K, spec_decode="spec", gamma=2,
                    draft_layers=2), admission={}), brownout)
        b = scen["brownout_ladder"]
        fleet_check("brownout_ladder", out, base_k,
                    reasons=["length"] * FLEET_REQUESTS,
                    monitor={"serving.brownout.escalations": 3,
                             "serving.brownout.recoveries": 3},
                    at_least={"serving.admission.resumes": 1},
                    dumps=["brownout_escalate", "brownout_recover"],
                    extra=b)
        if b["levels"][:8] != [0, 1, 1, 2, 2, 3, 3, 3] or \
                b["levels"][-1] != 0 or not b["spec"] or \
                not 2 <= b["graph_captures"] <= 4:
            raise AssertionError(f"5g brownout: {b}")
        release()
        parts["control"] = time.perf_counter() - t0

        # host_spill_flood (chaos_serving.py:925-968): prefix families
        # oversubscribe a 5-page pool; evicted registered pages spill to
        # the host tier and come back as swap-ins
        t0 = time.perf_counter()
        rng = np.random.default_rng(11)
        fam = []
        for _ in range(3):
            head = rng.integers(1, cfg.vocab_size - 1, 32)
            for _ in range(2):
                fam.append(np.concatenate(
                    [head, rng.integers(1, cfg.vocab_size - 1, 8)]))
        kw = dict(num_slots=1, kv_layout="paged", page_size=16,
                  num_pages=6, prefix_sharing=True)

        def tiers():
            r = EngineRouter([engine(host_kv_bytes=1 << 28, **kw)],
                             tracing=True, concurrent=False)
            r.plain = EngineRouter([engine(**kw)], tracing=True,
                                   concurrent=False)
            return r

        def flood(r):
            for rnd in range(2):
                pr = [r.plain.submit(p, FLEET_SPILL_NEW) for p in fam]
                r.plain.drain()
                reqs = [r.submit(p, FLEET_SPILL_NEW) for p in fam]
                r.drain()
                if [q.tokens for q in pr] != [q.tokens for q in reqs] or \
                        any(q.finish_reason != "length" for q in pr + reqs):
                    raise AssertionError(f"5g host_spill_flood round "
                                         f"{rnd}: the tiered streams part")
            return reqs
        out = run("host_spill_flood", tiers, flood)
        teng = out["router"].replicas[0].eng
        st = teng.pool_stats()["host_tier"]
        led = teng.memory_ledger()
        ok = (st["spills"] > 0 and st["swapins"] > 0
              and led["components"]["kv_pool_host"] == st["bytes"])
        scen["host_spill_flood"] = dict(st, ok=ok,
                                        launches=out["launches"],
                                        wall_s=out["wall_s"])
        log(json.dumps({"phase": "gpt_fleet", "scenario":
                        "host_spill_flood", **scen["host_spill_flood"]}))
        if not ok:
            raise AssertionError(f"5g host_spill_flood: {st}, ledger "
                                 f"{led['components']}")
        del out, teng
        release()
        parts["host_spill"] = time.perf_counter() - t0

        # process_crash_replay: collect the child, replay its journal
        t0 = time.perf_counter()
        child.wait(timeout=max(30.0, 600.0 - (time.perf_counter()
                                             - t_phase)))
        errf.close()
        with open(os.path.join(cdir, "stderr.txt")) as f:
            tail = f.read()[-3000:]
        if child.returncode != -signal.SIGKILL:
            raise AssertionError(f"5g crash child exited "
                                 f"{child.returncode}, not SIGKILL: {tail}")
        jdir = os.path.join(cdir, "journal")
        streams = {}

        def replay(r):
            reqs = list(r._pending)            # the journal's replays
            while r.has_work():
                for req, tok in r.step():
                    streams.setdefault(req.id, []).append(int(tok))
            r.close()
            return reqs
        out = run("process_crash_replay",
                  lambda: router(1, journal_dir=jdir), replay)
        wal = RequestJournal(jdir, fsync=False)
        admits, ends = set(), {}
        with open(wal.path, "rb") as f:
            for ln in f:
                rec = wal._parse(ln.rstrip(b"\n"))
                if rec is None:
                    raise AssertionError("5g crash replay: a torn record "
                                         "in a recovered WAL")
                if rec["ev"] == "admit":
                    admits.add(rec["id"])
                else:
                    ends[rec["id"]] = ends.get(rec["id"], 0) + 1
        wal.close()
        bad = [i for i in admits if ends.get(i, 0) != 1]
        ids = [r.id for r in out["reqs"]]
        parted = [i for i in ids if streams.get(i) != base[i]]
        line = {"phase": "gpt_fleet", "scenario": "process_crash_replay",
                "child_exit": child.returncode, "admits": len(admits),
                "replayed": ids, "ends": sum(ends.values()),
                "reasons": out["reasons"],
                "streams_equal": len(ids) - len(parted),
                "launches": out["launches"], "wall_s": out["wall_s"],
                "ok": (admits == set(range(FLEET_REQUESTS)) and not bad
                       and not parted and 0 < len(ids) < FLEET_REQUESTS
                       and out["reasons"] == ["length"] * len(ids))}
        log(json.dumps(line))
        if not line["ok"]:
            raise AssertionError(f"5g crash replay: {line}, exactly-once "
                                 f"misses {bad}, parted {parted}: {tail}")
        scen["process_crash_replay"] = line
        release()
        parts["crash_replay"] = time.perf_counter() - t0

        # a router tick's ms (after the crash child, which would share the
        # card and the host): 2 replicas over 4 requests stepped serially
        # and on threads, in mirrored order; then K = 4 replicas capturing
        # on threads
        t0 = time.perf_counter()
        ticks = {False: [], True: []}
        for conc in FLEET_TIMED:
            def timed(r):
                reqs = submit(r, reqs=prompts[:4])
                while r.has_work():
                    cuda_sync(torch, dev)
                    t_s = time.perf_counter()
                    r.step()
                    cuda_sync(torch, dev)
                    ticks[conc].append((time.perf_counter() - t_s) * 1e3)
                return reqs
            out = run(f"tick_{'concurrent' if conc else 'serial'}",
                      lambda conc=conc: router(2, concurrent=conc), timed)
            if out["streams"] != base[:4]:
                raise AssertionError(f"5g timed run (concurrent={conc}): "
                                     "streams part from the base run")
            out["router"].close()
            release()
        out = run("k4_concurrent", lambda: router(
            2, dict(multi_tick=FLEET_K), concurrent=True),
            drained(FLEET_NEW_LONG))
        caps = [e.counters["graph_captures"] for e in made]
        fleet_check("k4_concurrent", out, base_k,
                    reasons=["length"] * FLEET_REQUESTS,
                    extra={"graph_captures": caps})
        if caps != [1, 1]:
            raise AssertionError(f"5g k4_concurrent captures {caps}")
        out["router"].close()
        release()
        timing = {"tick_ms_p50_serial": statistics.median(ticks[False]),
                  "tick_ms_p50_concurrent": statistics.median(ticks[True]),
                  "ticks_timed": [len(ticks[False]), len(ticks[True])],
                  # serving.router.dispatch_ms over the phase's routers
                  # (process-wide: the reservoir histogram's snapshot)
                  "dispatch_ms": out["router"]._m_disp_ms.value,
                  "card": card}
        scen["timing"] = timing
        log(json.dumps({"phase": "gpt_fleet", "part": "router_tick",
                        **timing}))
        parts["timing"] = time.perf_counter() - t0

    finally:
        if child is not None and child.poll() is None:
            child.kill()
            child.wait()
        flight_recorder.recorder().set_dir(old_flight)
        shutil.rmtree(tmp, ignore_errors=True)
    log(json.dumps({"phase": "gpt_fleet", "card": card,
                    "scenarios": len(scen), "seconds_by_part": parts,
                    "launches": launches, "replay_launches": replays}))
    gc.collect()
    torch.cuda.empty_cache()
    return launches, {"replays": replays}


def llama_host_params():
    """The TinyLlama-width config at LLAMA_SERVE_LAYERS layers and its
    weights, drawn on the host from seed 0 once for phases 5b-5e."""
    from paddle_tpu_torch.models.llama import LlamaConfig, init_llama_params
    cfg = LlamaConfig(**dict(LLAMA, num_layers=LLAMA_SERVE_LAYERS))
    t0 = time.perf_counter()
    params = init_llama_params(cfg, seed=0, device="cpu")
    log(f"llama host params drawn in {time.perf_counter() - t0:.1f} s")
    return cfg, params


def llama_prompts(vocab):
    """Phase 5b's 16 prompts of 16..1024 tokens (seed 5)."""
    rng = np.random.default_rng(5)
    lens = rng.integers(16, 1025, size=16)
    return [rng.integers(0, vocab, size=int(n)) for n in lens]


def llama_serving(torch, qm, dev, card, cfg, params):
    """Phase 5b, Llama at TinyLlama-1.1B widths: 16 requests, prompts of
    16..1024 tokens (seed 5), max_len 2048. Returns (launches on the
    main path, summary dict)."""
    prompts = llama_prompts(cfg.vocab_size)
    per_pass = sum(pass_calls(LLAMA_LEAF_KN, cfg.num_layers).values())
    return serve(torch, qm, dev, card, "llama", cfg, params, prompts, 2048,
                 per_pass)


# phase 5c: the paged and speculative Llama engines
# new tokens a request of 5c's prompts (5c, and 5d's engines held to 5c)
PAGED_NEW = 16
PAGED = dict(kv_layout="paged", page_size=16, prefill_chunk=256,
             num_pages=513)
SPEC = dict(spec_decode="spec", gamma=4, draft_layers=2)
SAMPLED = {3: (0.8, 40), 11: (1.0, 20)}


def paged_prompts(vocab):
    """16 prompts (seed 7): a shared 512-token prefix and a suffix of
    16..512 tokens; request 0's suffix is 256 tokens (768 = 48 full
    pages of 16) and requests 14 and 15 repeat request 0's prompt, so
    their admission maps every page and copies the last one."""
    rng = np.random.default_rng(7)
    prefix = rng.integers(0, vocab, size=512)
    lens = rng.integers(16, 513, size=16)
    lens[0] = 256
    prompts = [np.concatenate([prefix, rng.integers(0, vocab, size=int(n))])
               for n in lens]
    prompts[14] = prompts[15] = prompts[0].copy()
    return prompts


def engine_forced_logits(torch, qmm, qp, prompt, tokens, cfg, dev, max_len,
                         layout, page_size=16, chunk=256, window=0):
    """The logits each of `tokens` is picked from on a Llama engine's own
    path, the stream teacher-forced into a one-row cache: "dense", the
    bucketed prefill into a bucket-long cache copied into a max_len row;
    "paged", the prefill in `chunk`-token chunks at absolute positions
    through a page table; then one-token steps at per-row positions.
    With `window` > 0 the last `window` tokens come from one forward of
    that many tokens, as a spec tick's verify pass makes them. prompt
    [T0] and tokens on the host; returns [len(tokens), V] f32."""
    from paddle_tpu_torch.models.decode import prompt_bucket
    from paddle_tpu_torch.models.llama import (init_kv_cache,
                                               llama_forward_cached)
    T0, n = len(prompt), len(tokens)
    window = min(window, n - 1)

    def ids(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.int64,
                               device=dev)[None]

    def at(p):
        return torch.tensor([p], dtype=torch.int64, device=dev)
    with torch.no_grad():
        if layout == "dense":
            tb = prompt_bucket(T0, max_len)
            mini = init_kv_cache(cfg, 1, tb, device=dev)
            padded = np.zeros(tb, np.int64)
            padded[:T0] = prompt
            lg, _ = llama_forward_cached(qp, ids(padded), mini, 0, cfg,
                                         qmm=qmm)
            cache = init_kv_cache(cfg, 1, max_len, device=dev)
            for key in ("k", "v"):
                cache[key][:, :, :tb] = mini[key]
            last = T0 - 1
        else:
            mp = -(-max_len // page_size)
            cache = init_kv_cache(cfg, mp + 1, page_size, device=dev)
            cache["pt"] = torch.arange(1, mp + 1, device=dev)[None]
            for start in range(0, T0, chunk):
                clen = min(chunk, T0 - start)
                padded = np.zeros(prompt_bucket(clen, max_len), np.int64)
                padded[:clen] = prompt[start:start + clen]
                lg, _ = llama_forward_cached(qp, ids(padded), cache,
                                             at(start), cfg, qmm=qmm)
            last = clen - 1
        rows = [lg[0, last].float()]
        steps = n - 1 - window
        for i in range(steps):
            lg, _ = llama_forward_cached(qp, ids([tokens[i]]), cache,
                                         at(T0 + i), cfg, qmm=qmm)
            rows.append(lg[0, -1].float())
        if window:
            lg, _ = llama_forward_cached(
                qp, ids(tokens[steps:steps + window]), cache, at(T0 + steps),
                cfg, qmm=qmm)
            rows.extend(lg[0].float())
    return torch.stack(rows)


def parting_verdict(torch, qm, qp, cfg, dev, prompt, stream_a, stream_b,
                    paths, weights64, logit_tol=0.05, own_check=True):
    """Phase 5b's verdict at the first step j0 where two greedy streams
    of one request part, each stream replayed teacher-forced (up to j0)
    along the path that made it (`paths`: (name, engine_forced_logits
    keywords) for stream_a's engine, then stream_b's):
    - every int8 call of both replays within the f64 bound on its own
      input;
    - the two paths' logits on the common prefix within `logit_tol` of
      the span at every step;
    - each replay gives its own stream back, up to `logit_tol` of the
      span: at every step its engine's token lies that close to the
      replay's top logit (a made-up token is far outside).
    A prompt whose prefix pages the engine shared is replayed from its
    first token, as the donor computed those pages. `weights64` is
    f64_oracle's cache. A sampled stream (`own_check` False) is not
    held to its replay's top logit. Two streams judged along the same
    path share one replay (the tokens before j0 are theirs alike).
    Returns the report; report["ok"] says whether it passed."""
    j0 = next(j for j in range(len(stream_a)) if stream_a[j] != stream_b[j])
    per_pass = sum(pass_calls(LLAMA_LEAF_KN, cfg.num_layers).values())
    out = {"step": j0, "tokens": [stream_a[j0], stream_b[j0]]}
    logits = []
    ok = True
    for (name, kw), stream in zip(paths, (stream_a, stream_b)):
        if logits and kw == paths[0][1]:
            # the same path over the same tokens before j0: the same
            # replay (row j0 predicts token j0 from the tokens before it)
            lg = logits[0]
        else:
            checked, f64 = f64_checked(torch, qm.quant_matmul, None,
                                       per_pass, weights64=weights64)
            lg = engine_forced_logits(torch, checked, qp, prompt,
                                      stream[:j0 + 1], cfg, dev, 2048, **kw)
        logits.append(lg)
        own = lg.gather(1, torch.as_tensor(stream[:j0 + 1],
                                           device=lg.device)[:, None])[:, 0]
        behind = float(((lg.amax(-1) - own) / lg.abs().amax(-1)).max())
        f64_ok = f64["kernel_calls_within_bound"] == f64["calls"]
        ok &= f64_ok and (behind <= logit_tol or not own_check)
        hi = float(lg[j0].abs().max())
        out[name] = {"calls": f64["calls"], "f64_ok": f64_ok,
                     "kernel_max_bound_share": f64["kernel_max_bound_share"],
                     "own_token_behind_top_over_span": behind,
                     "logits_at_parting": [float(lg[j0, t])
                                           for t in out["tokens"]],
                     "gap_bf16_steps": abs(float(lg[j0, stream_a[j0]]
                                                 - lg[j0, stream_b[j0]]))
                     / (2.0 ** -7 * hi)}
    la, lb = logits
    err = float(((la - lb).abs().amax(-1) / lb.abs().amax(-1)).max())
    out["logit_err_over_span"] = err
    out["ok"] = ok and err <= logit_tol
    return out


def compare_streams(torch, qm, qp, cfg, dev, prompts, got, want, label,
                    paths, sampled=SAMPLED, sampled_verdict=False,
                    strict=False):
    """Streams of two engines on the same prompts: how many agree token
    for token, and phase 5b's verdict at every greedy parting. With
    `sampled_verdict` a parting of a `sampled` request is held to it
    too, but for its own tokens, which need not be the top logit's.
    Raises unless every parting passes; with `strict`, at any parting,
    sampled or greedy."""
    greedy = [i for i in range(len(prompts)) if i not in sampled]
    parted = [i for i in (range(len(prompts)) if sampled_verdict
                          else greedy) if got[i] != want[i]]
    if strict and any(a != b for a, b in zip(got, want)):
        raise AssertionError(f"{label}: streams part")
    t0 = time.perf_counter()
    weights64, verdicts, seen = {}, {}, {}
    for i in parted:
        # requests with one prompt and the same two streams (14 and 15
        # repeat request 0's prompt) share one verdict
        key = (prompts[i].tobytes(), tuple(got[i]), tuple(want[i]))
        if key not in seen:
            seen[key] = parting_verdict(torch, qm, qp, cfg, dev, prompts[i],
                                        got[i], want[i], paths, weights64,
                                        own_check=i not in sampled)
        verdicts[i] = seen[key]
    del weights64
    line = {"phase": f"llama_{label}_streams",
            "greedy_equal": sum(got[i] == want[i] for i in greedy),
            "greedy_requests": len(greedy),
            "sampled_equal": sum(got[i] == want[i] for i in sampled),
            "sampled_requests": len(sampled),
            "partings": verdicts, "seconds": time.perf_counter() - t0}
    log(json.dumps(line))
    bad = [i for i, v in verdicts.items() if not v["ok"]]
    if bad:
        raise AssertionError(f"{label}: partings of requests {bad} fail the "
                             "f64 / logit verdict")
    return line


def pool_check(eng):
    """The page pool's accounting between ticks: table references equal
    the refcounts, every page but scratch is exactly one of free, cached
    and live, reservations are conserved, and no active slot maps a page
    past its position. Raises on a break; returns pages in use."""
    pool, ptab = eng._pool, eng._ptab
    refs = np.zeros(pool.num_pages, np.int64)
    refs[0] = 1
    np.add.at(refs, ptab[ptab != 0], 1)
    free, cached = set(pool.free), set(pool.cached)
    live = set(np.nonzero(pool.ref[1:] > 0)[0] + 1)
    ps = eng.page_size
    past = [i for i in np.nonzero(eng._active)[0]
            if ptab[i, -(-int(eng._positions[i]) // ps):].any()]
    if (not np.array_equal(refs, pool.ref) or free & cached or free & live
            or cached & live
            or len(free) + len(cached) + len(live) != pool.num_pages - 1
            or pool.reserved != int(eng._slot_reserve.sum()) or past):
        raise AssertionError(f"page pool accounting broke: {pool.stats()}, "
                             f"slots mapping past their position {past}")
    return len(live)


def count_warmups(torch, qm, eng):
    """The int8 launches of each eager K-tick run of a multi-tick engine
    (each flag's first dispatch, before its capture), in a list the
    caller reads; a call under capture launches nothing and is not
    listed."""
    warm = []
    run = eng._multi_ticks

    def counted(sampling):
        n0 = qm.launches
        out = run(sampling)
        if not torch.cuda.is_current_stream_capturing():
            warm.append(qm.launches - n0)
        return out
    eng._multi_ticks = counted
    return warm


def check_launches(eng, label, c, launches, per_pass, per_tick, warm,
                   captured=0):
    """The int8 launches of a run (counter deltas `c`) against the path:
    `per_pass` a prefill (a chunk, paged) and `per_tick` a tick. Under
    multi-tick only the eager dispatches launch through the wrapper,
    each flag's warm-up (K x per_tick, `warm`), and every later dispatch
    is a graph replay; each capture records K x per_tick kernel launches
    (`captured`, the wrapper's count under capture), which each replay
    runs; the engine's own count takes K x per_tick a dispatch."""
    passes = c["prefill_chunks"] if eng.paged else c["prefills"]
    k = eng.mt_k
    eager = c["decode_ticks"] if k == 1 else c["graph_captures"]
    want = per_pass * passes + k * per_tick * eager
    counted = per_pass * passes + k * per_tick * c["decode_ticks"]
    if launches != want or c["quant_matmuls"] != counted:
        raise AssertionError(
            f"{label} kernel launches {launches} != {want} ({per_pass} x "
            f"{passes} passes + {k} x {per_tick} x {eager} eager "
            f"dispatches), or the engine's count {c['quant_matmuls']} != "
            f"{counted}")
    if k > 1 and (any(n != k * per_tick for n in warm)
                  or len(warm) != c["graph_captures"]
                  or c["graph_replays"] != c["decode_ticks"]
                  - c["graph_captures"]
                  or captured != k * per_tick * c["graph_captures"]
                  or eng.counters["graph_captures"] > 2):
        raise AssertionError(
            f"{label}: warm-up launches {warm} (each {k} x {per_tick}), "
            f"{c['graph_replays']} replays of {c['decode_ticks']} "
            f"dispatches, {captured} launches captured in "
            f"{c['graph_captures']} graphs, "
            f"{eng.counters['graph_captures']} graphs in all")


# the threefry kernel's launches on the serving main paths, summed by
# `sampling_phase` over each serving phase: through the wrapper, recorded
# into CUDA graphs, and run by graph replays
DRAWS = {"launches": 0, "captured": 0, "replayed": 0}


def check_draws(eng, label, c, launches, captured):
    """The threefry kernel's launches of a main-path run (counter deltas
    `c`) against the sampler's draws: one a prefill pass that sampled
    and one a tick of a sampled dispatch. Under multi-tick only the
    eager dispatches launch through the wrapper, each sampled flag's
    warm-up (K), and each sampled capture records K, which its replays
    run. Adds the run's launches to DRAWS."""
    k = eng.mt_k
    eager = c["sampled_dispatches"] if k == 1 else c["sampled_captures"]
    want = c["sampled_passes"] + k * eager
    want_cap = 0 if k == 1 else k * c["sampled_captures"]
    if launches != want or captured != want_cap:
        raise AssertionError(
            f"{label} threefry kernel launches {launches} != {want} "
            f"({c['sampled_passes']} sampled passes + {k} x {eager} "
            f"sampled eager dispatches), or {captured} recorded under "
            f"capture != {want_cap}")
    DRAWS["launches"] += launches
    DRAWS["captured"] += captured
    if k > 1:
        DRAWS["replayed"] += k * (c["sampled_dispatches"]
                                  - c["sampled_captures"])


def run_engine(torch, qm, eng, prompts, label, card, per_pass, per_tick,
               profile=True, new_tokens=64):
    """Drive one 5c or 5d engine over `prompts` (`new_tokens` each,
    SAMPLED with top-k), step by step, with its launches asserted at
    `per_pass` a prefill (a chunk under the paged layout) and `per_tick`
    a decode tick (`check_launches`), and under the paged layout the
    pool checked after every step and empty at the end. Chunks are timed
    to a synchronize on each side (an earlier chunk makes no host pull
    of its own). Returns (streams, summary, launches)."""
    from paddle_tpu_torch.kernels import threefry as tf
    chunk_ms = []
    warm = count_warmups(torch, qm, eng) if eng.mt_k > 1 else []
    if eng.paged:
        run_chunk = eng._run_chunk

        def timed(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run_chunk(*args)
            torch.cuda.synchronize()
            chunk_ms.append((time.perf_counter() - t0) * 1e3)
        eng._run_chunk = timed
    eng.generate([prompts[1][-12:]], 4)          # warm-up, registers nothing
    torch.cuda.synchronize()
    c0 = dict(eng.counters)
    n_tick_ms0, n_pf_ms0 = len(eng.tick_ms), len(eng.prefill_ms)
    n_cap0 = len(eng.capture_ms)
    del chunk_ms[:], warm[:]
    torch.cuda.reset_peak_memory_stats()
    allocated0 = torch.cuda.memory_allocated()
    peak_pages = 0

    qm.launches = 0                          # the main path starts here
    cap0 = qm.captured
    tf.launches["threefry_bits"] = 0
    tf_cap0 = tf.captured
    t_run = time.perf_counter()
    reqs = [eng.submit(p, new_tokens,
                       temperature=SAMPLED.get(i, (0.0, 0))[0],
                       top_k=SAMPLED.get(i, (0.0, 0))[1])
            for i, p in enumerate(prompts)]
    while eng.has_work():
        eng.step()
        if eng.paged:
            peak_pages = max(peak_pages, pool_check(eng))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_run
    launches = qm.launches                   # ... and ends here

    c = {k: v - c0[k] for k, v in eng.counters.items()}
    reasons = [r.finish_reason for r in reqs]
    if any(r != "length" for r in reasons):
        raise AssertionError(f"{label} finish reasons {reasons}")
    check_launches(eng, label, c, launches, per_pass, per_tick, warm,
                   qm.captured - cap0)
    check_draws(eng, label, c, tf.launches["threefry_bits"],
                tf.captured - tf_cap0)
    for r in reqs:
        toks = np.asarray(r.tokens)
        if len(toks) != new_tokens or toks.min() < 0 or toks.max() >= \
                eng.cfg.vocab_size:
            raise AssertionError(f"{label} request {r.id}: bad tokens")
    tick_ms = list(eng.tick_ms)[n_tick_ms0:]
    pf_ms = chunk_ms if eng.paged else list(eng.prefill_ms)[n_pf_ms0:]
    summary = {
        "phase": f"llama_{label}", "card": card, "requests": len(reqs),
        "new_tokens": new_tokens * len(reqs), "prefills": c["prefills"],
        "prefill_chunks": c["prefill_chunks"],
        "decode_ticks": c["decode_ticks"], "launches": launches,
        "launches_per_pass": per_pass, "launches_per_tick": per_tick,
        "wall_s": wall, "tokens_per_s": new_tokens * len(reqs) / wall,
        "tick_ms_p50": statistics.median(tick_ms),
        "tick_ms_p90": float(np.percentile(tick_ms, 90)),
        "prefill_ms_p50": statistics.median(pf_ms),
        "prefill_ms_max": max(pf_ms),
        "prefill_timed": "each chunk between synchronizes" if eng.paged
        else "each prefill to its host pull",
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "memory_allocated_at_start_bytes": allocated0,
        "kv_cache_bytes": sum(v.numel() * v.element_size()
                              for k, v in eng._cache.items() if k != "pt"),
    }
    if eng.mt_k > 1:
        summary.update({
            "multi_tick": eng.mt_k,
            "dispatch_ms_p50": summary["tick_ms_p50"],
            "dispatch_ms_p90": summary["tick_ms_p90"],
            "ms_per_token_tick": summary["tick_ms_p50"] / eng.mt_k,
            "tokens_per_dispatch": (c["tokens_emitted"] - c["prefills"])
            / c["decode_ticks"],
            "graph_captures": c["graph_captures"],
            "graph_replays": c["graph_replays"],
            "replay_launches": c["graph_replays"] * eng.mt_k * per_tick,
            "graphs": eng.counters["graph_captures"],
            "capture_ms": eng.capture_ms[n_cap0:],
            "warmup_launches": warm, "tick_ms": "per dispatch"})
    if eng.spec:
        rate = c["spec_accepted"] / max(c["spec_proposed"], 1)
        summary.update({
            "spec_proposed": c["spec_proposed"],
            "spec_accepted": c["spec_accepted"], "acceptance_rate": rate,
            "tokens_per_tick": (c["tokens_emitted"] - c["prefills"])
            / (c["decode_ticks"] * eng.mt_k),
            "tokens_per_greedy_slot_tick": 1 + eng.spec_gamma * rate,
            "acceptance_note": "random weights: says nothing of a trained "
                               "model's acceptance or speed-up"})
    if eng.paged:
        st = eng.pool_stats()
        summary.update({"peak_pages_in_use": peak_pages, "pool": st})
        if st["pages_in_use"] or st["pages_reserved"] or \
                st["pages_free"] + st["pages_cached"] != st["num_pages"] - 1:
            raise AssertionError(f"{label}: the pool is not empty at the "
                                 f"end: {st}")
        if not (st["prefix_hits"] and st["cow_copies"]
                and st["prefill_chunks"]):
            raise AssertionError(f"{label}: no prefix hit, COW copy or "
                                 f"chunk: {st}")
    log(json.dumps(summary))
    if profile and (eng.paged or eng.mt_k > 1):
        summary["profile"] = tick_profile(torch, eng, prompts, card,
                                          f"llama_{label}_")
    return [list(r.tokens) for r in reqs], summary, launches


def paged_serving(torch, qm, dev, card, cfg, params):
    """Phase 5c: the int8 Llama engine at TinyLlama widths with the paged
    cache (PAGED: page 16, chunks of 256, 513 pages, half the dense
    equivalent), prefix sharing and copy-on-write, then with speculative
    decode (SPEC), each beside a dense engine on the same prompts
    (`paged_prompts`); streams compared, every parting held to phase 5b's
    verdict. Returns (the int8 kernel's launches {path: n}, {label:
    summary} with each engine's streams)."""
    from paddle_tpu_torch.inference import ServingEngine
    prompts = paged_prompts(cfg.vocab_size)
    per_pass = sum(pass_calls(LLAMA_LEAF_KN, cfg.num_layers).values())
    draft = sum(pass_calls(LLAMA_LEAF_KN, SPEC["draft_layers"]).values())
    spec_tick = per_pass + SPEC["gamma"] * draft        # 29 + 4 x 15
    streams, launches, summaries = {}, {}, {}
    for label, kw in (("paged", PAGED), ("dense", {"kv_layout": "dense"}),
                      ("spec", dict(PAGED, **SPEC)),
                      ("dense_spec", dict(kv_layout="dense", **SPEC))):
        t0 = time.perf_counter()
        eng = ServingEngine(params, cfg, family="llama", num_slots=8,
                            max_len=2048, max_top_k=50, seed=0, quant="int8",
                            **kw)
        log(json.dumps({"phase": f"llama_{label}_build", "knobs": kw,
                        "seconds": time.perf_counter() - t0}))
        streams[label], summaries[label], launches[label] = run_engine(
            torch, qm, eng, prompts, label, card, per_pass,
            spec_tick if eng.spec else per_pass, new_tokens=PAGED_NEW)
        summaries[label]["streams"] = streams[label]
        # the int8 tree (the same from every build) for the verdicts
        qp = eng._params if label == "dense_spec" else None
        del eng
        gc.collect()        # the chunk timer and the engine hold each other
        torch.cuda.empty_cache()
    dense_path = {"layout": "dense"}
    paged_path = {"layout": "paged", "page_size": 16, "chunk": 256}
    for label, got, want, paths in (
            ("paged_vs_dense", "paged", "dense",
             (("paged", paged_path), ("dense", dense_path))),
            ("spec_vs_paged", "spec", "paged",
             (("verify", dict(paged_path, window=SPEC["gamma"] + 1)),
              ("paged", paged_path))),
            ("dense_spec_vs_dense", "dense_spec", "dense",
             (("verify", dict(dense_path, window=SPEC["gamma"] + 1)),
              ("dense", dense_path)))):
        compare_streams(torch, qm, qp, cfg, dev, prompts, streams[got],
                        streams[want], label, paths)
    del qp
    torch.cuda.empty_cache()
    return ({"llama_paged": launches["paged"], "llama_spec": launches["spec"]},
            summaries)


# phase 5e: the int8 Llama engine tensor-parallel over two ranks
TP = 2
# a tp2 rank's int8 leaves at TinyLlama widths (q, gate and up split by
# column, o and down by row, k and v by their KV heads, the head by the
# vocabulary)
TP_LEAF_KN = {"q_w": (_D, _D // TP), "o_w": (_D // TP, _D),
              "k_w/v_w": (_D, _KV // TP), "gate_w/up_w": (_D, _F // TP),
              "down_w": (_F // TP, _D), "head": (_D, 32000 // TP)}
TP_ENGINES = (("tp2", {"kv_layout": "dense"}, "llama_prompts"),
              ("tp2_spec", dict(PAGED, **SPEC), "paged_prompts"))
# the requests of 5b's and 5c's lists that 5e serves (a request's stream
# depends only on its prompt and, sampled, on its id, which keeps its
# order): request 3 sampled, and 14 and 15, which repeat request 0's
# prompt and queue behind the 8 slots, so the paged engine maps request
# 0's registered pages and copies the last one
TP_REQUESTS = (0, 1, 2, 3, 4, 5, 6, 7, 14, 15)
# new tokens a 5e request: the first quarter of 5b's and 5c's 64 (a
# stream's first tokens do not depend on how many follow)
TP_NEW_TOKENS = 16


# 5e (b): serving_device_loss (tools/chaos_serving.py:890-923) on the
# paged int8 tp2 engine: the preempt guard wedges the last rank's lease at
# its poll 16, degrades tp2 -> tp1 through plan_serving_tp and rebuilds
# (the reference's drill loses it at poll 3, over prompts of 3-20 tokens;
# 5c's prompts prefill one 256-token chunk a tick, so at poll 3 most would
# still be mid-prefill and end "evicted" instead of moving)
TP_PREEMPT = "replica_preempt@16:1"


def tp_preempt_drill(torch, qm, cfg, mesh, per_pass):
    """5e (b) on this rank: the paged int8 engine (PAGED, no spec) over
    5c's TP_REQUESTS with an EnginePreemptGuard polled after every tick
    under TP_PREEMPT. The rank that stays rebuilds at tp1 and serves its
    live streams on (one pull a dispatch after the rebuild, counted),
    the one that leaves retires its engine. Launches and draws are
    checked as `run_engine` checks them. Returns the rank's record."""
    import tempfile
    from paddle_tpu_torch.inference import EnginePreemptGuard, ServingEngine
    from paddle_tpu_torch.kernels import threefry as tf
    from paddle_tpu_torch.profiler import flight_recorder
    from paddle_tpu_torch.testing import faults
    fdir = tempfile.mkdtemp(prefix="chip_smoke_5e_preempt_")
    rec = flight_recorder.recorder()
    rec.clear()
    rec.set_dir(fdir)
    eng = ServingEngine({}, cfg, family="llama", num_slots=8, max_len=2048,
                        max_top_k=50, seed=0, quant="int8", mesh=mesh,
                        **PAGED)
    prompts = tp_prompts("paged_prompts", cfg.vocab_size)
    eng.generate([prompts[1][-12:]], 4)        # run_engine's warm-up
    torch.cuda.synchronize()
    c0 = dict(eng.counters)
    guard = EnginePreemptGuard(eng, lease_timeout_s=5.0)
    DRAWS.update(launches=0, captured=0, replayed=0)
    qm.launches = 0                          # the main path starts here
    cap0 = qm.captured
    tf.launches["threefry_bits"] = 0
    tf_cap0 = tf.captured
    faults.install(TP_PREEMPT, once_dir=fdir + ".once")
    new_tp, pulls, post, rebuild_s = 0, None, 0, None
    t0 = time.perf_counter()
    try:
        reqs = [eng.submit(p, TP_NEW_TOKENS,
                           temperature=SAMPLED.get(i, (0.0, 0))[0],
                           top_k=SAMPLED.get(i, (0.0, 0))[1])
                for i, p in enumerate(prompts)]
        while eng.has_work():
            eng.step()
            if pulls is not None:
                post += 1
            t_p = time.perf_counter()
            tp = guard.poll()
            if tp:
                torch.cuda.synchronize()
                rebuild_s = time.perf_counter() - t_p
                new_tp = tp
                c_rb = dict(eng.counters)
                pulls = [0]
                pull = eng._pull

                def counted(value, stall_s=0.0, pull=pull, n=pulls):
                    n[0] += 1
                    return pull(value, stall_s)
                eng._pull = counted
        torch.cuda.synchronize()
    finally:
        faults.uninstall()
        rec.set_dir(None)
    wall = time.perf_counter() - t0
    launches = qm.launches                   # ... and ends here
    c = {k: v - c0[k] for k, v in eng.counters.items()}
    check_launches(eng, "tp2_preempt", c, launches, per_pass, per_pass, [],
                   qm.captured - cap0)
    check_draws(eng, "tp2_preempt", c, tf.launches["threefry_bits"],
                tf.captured - tf_cap0)
    dumps = sorted(flight_recorder.load_dump(os.path.join(fdir, f))[
        "reason"] for f in os.listdir(fdir))
    import shutil
    shutil.rmtree(fdir, ignore_errors=True)
    shutil.rmtree(fdir + ".once", ignore_errors=True)
    after = ({k: eng.counters[k] - c_rb[k] for k in ("decode_ticks",
                                                     "prefills")}
             if pulls is not None else {})
    return {"streams": [list(map(int, r.tokens)) for r in reqs],
            "reasons": [r.finish_reason for r in reqs], "new_tp": new_tp,
            "tp": eng.tp, "retired": eng._retired,
            "has_work": eng.has_work(),
            "pulls_after": None if pulls is None else pulls[0],
            "ticks_after": post, "after": after, "rebuild_s": rebuild_s,
            "wall_s": wall,
            "decode_ticks": c["decode_ticks"],
            "prefill_chunks": c["prefill_chunks"], "dumps": dumps,
            "launches": launches, "draws": dict(DRAWS)}


def tp_prompts(name, vocab):
    """The TP_REQUESTS of a prompt list (`llama_prompts` or
    `paged_prompts`)."""
    prompts = globals()[name](vocab)
    return [prompts[i] for i in TP_REQUESTS]


def _tp_serving_rank(rank, world, workdir, engines=None):
    """One rank of phase 5e, in its own process: joins the tp group
    through a file store (NCCL with a card a rank, gloo when the ranks
    share one), loads the int8 tree phase 5b quantized (handed to the
    engine in place of a second rewrite) and runs each of TP_ENGINES
    (or `engines`) over its prompts through `run_engine` (launches and
    draws checked there, the pool after every step), the tp collectives
    of every dispatch counted; then (b), `tp_preempt_drill`. Writes its
    results to workdir/rank<rank>.json."""
    bind_to_script()
    import torch
    import torch.distributed as dist
    t0 = time.perf_counter()
    cards = torch.cuda.device_count()
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank % cards))
    sys.path.insert(0, HERE)
    from paddle_tpu_torch.device import resolve_device
    from paddle_tpu_torch.inference import ServingEngine
    from paddle_tpu_torch.kernels import quant_matmul as qm
    from paddle_tpu_torch.models.llama import LlamaConfig
    from paddle_tpu_torch.parallel import collective_route, init_parallel_env
    from paddle_tpu_torch.parallel.mesh import build_mesh
    from paddle_tpu_torch.quantization import serving as qs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = resolve_device(None)
    torch.cuda.set_device(dev)
    init_parallel_env(backend="nccl" if cards >= world else "gloo",
                      init_method=f"file://{workdir}/store", timeout_s=900)
    out = {"rank": rank, "device": str(dev)}
    try:
        tree = torch.load(os.path.join(workdir, "int8.pt"), mmap=True,
                          weights_only=False)
        qs.quantize_serving_params = lambda params, family: tree
        cfg = LlamaConfig(**dict(LLAMA, num_layers=LLAMA_SERVE_LAYERS))
        mesh = build_mesh({"tp": world})
        out["route"] = collective_route(mesh.get_group("tp"), dev)
        out["start_s"] = time.perf_counter() - t0
        per_pass = sum(pass_calls(TP_LEAF_KN, cfg.num_layers).values())
        draft = sum(pass_calls(TP_LEAF_KN, SPEC["draft_layers"]).values())
        for label, kw, prompts_fn in (TP_ENGINES if engines is None
                                      else engines):
            t_b = time.perf_counter()
            eng = ServingEngine({}, cfg, family="llama", num_slots=8,
                                max_len=2048, max_top_k=50, seed=0,
                                quant="int8", mesh=mesh, **kw)
            build_s = time.perf_counter() - t_b
            shapes = sorted({tuple(v.shape) for k, v in eng._params.items()
                             if k.endswith("_q")})
            dispatch = eng._dispatch
            per_dispatch = []

            def counted(sampling, dispatch=dispatch, eng=eng,
                        per_dispatch=per_dispatch):
                n0 = eng._layout.collectives
                emit = dispatch(sampling)
                per_dispatch.append(eng._layout.collectives - n0)
                return emit
            eng._dispatch = counted
            DRAWS.update(launches=0, captured=0, replayed=0)
            streams, summary, launches = run_engine(
                torch, qm, eng, tp_prompts(prompts_fn, cfg.vocab_size),
                label, out["device"], per_pass,
                per_pass + SPEC["gamma"] * draft if eng.spec else per_pass,
                profile=False, new_tokens=TP_NEW_TOKENS)
            out[label] = {
                "streams": streams, "launches": launches,
                "draws": dict(DRAWS), "build_s": build_s,
                "int8_shapes": shapes,
                "kv_cache_shape": list(eng._cache["k"].shape),
                "collectives_per_dispatch": sorted(set(per_dispatch[1:])),
                **{k: summary[k] for k in (
                    "tick_ms_p50", "tick_ms_p90", "prefill_ms_p50",
                    "prefill_ms_max", "decode_ticks", "prefills",
                    "prefill_chunks", "wall_s", "tokens_per_s",
                    "max_memory_allocated_bytes", "kv_cache_bytes")}}
            del eng, counted
            gc.collect()
            torch.cuda.empty_cache()
        out["tp2_preempt"] = tp_preempt_drill(torch, qm, cfg, mesh,
                                              per_pass)
        gc.collect()
        torch.cuda.empty_cache()
        out["seconds"] = time.perf_counter() - t0
    finally:
        with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
        dist.destroy_process_group()


def tp_preempt_check(torch, qm, cfg, dev, ranks, k1c, tree, qp=None):
    """5e (b)'s verdict on the two ranks' `tp_preempt_drill` records: the
    guard left rank 0 at tp1 and retired rank 1 (no work), one pull a
    dispatch after the rebuild, the serving_preempt and serving_rebuild
    dumps, every request "length" on rank 0 (or "evicted" mid-prefill,
    its stream a prefix) and "migrated" or "evicted" on rank 1; rank
    0's finished streams equal 5c's single-card paged engine's, or each
    parting passes 5b's f64 verdict (`compare_streams`). Returns (both
    ranks' int8 launches, their draws, the summary)."""
    from paddle_tpu_torch.inference.serving import _to_device
    stay, left = (r["tp2_preempt"] for r in ranks)
    bad = []
    if (stay["new_tp"], left["new_tp"], stay["tp"]) != (1, 1, 1) or \
            stay["retired"] or not left["retired"] or left["has_work"]:
        bad.append("the guard did not leave rank 0 at tp1 and retire "
                   "rank 1")
    # one pull a dispatch and one a finished prefill (the queued
    # requests admit on the new mesh)
    a = stay["after"]
    if not a.get("decode_ticks") or \
            stay["pulls_after"] != a["decode_ticks"] + a["prefills"]:
        bad.append(f"{stay['pulls_after']} pulls after the rebuild, for "
                   f"{a} dispatches and prefills")
    if "serving_preempt" not in stay["dumps"] or \
            "serving_rebuild" not in stay["dumps"]:
        bad.append(f"dumps {stay['dumps']}")
    if any(why not in ("length", "evicted") for why in stay["reasons"]) or \
            any(why not in ("migrated", "evicted")
                for why in left["reasons"]):
        bad.append(f"reasons {stay['reasons']} / {left['reasons']}")
    single = [k1c["paged"]["streams"][i][:TP_NEW_TOKENS]
              for i in TP_REQUESTS]
    done = [i for i, why in enumerate(stay["reasons"]) if why == "length"]
    evicted = [i for i, why in enumerate(stay["reasons"])
               if why == "evicted"]
    if any(stay["streams"][i] != single[i][:len(stay["streams"][i])]
           for i in evicted):
        bad.append("an evicted stream is not a prefix of 5c's")
    if bad:
        raise AssertionError(f"5e (b) tp2_preempt: {bad}")
    prompts = tp_prompts("paged_prompts", cfg.vocab_size)
    if qp is None and [stay["streams"][i] for i in done] != \
            [single[i] for i in done]:
        qp = _to_device(tree[0], dev)
    paged_path = {"layout": "paged", "page_size": 16, "chunk": 256}
    verdict = compare_streams(
        torch, qm, qp, cfg, dev, [prompts[i] for i in done],
        [stay["streams"][i] for i in done], [single[i] for i in done],
        "tp2_preempt_vs_single_card",
        (("tp2_then_tp1", paged_path), ("single", paged_path)),
        sampled={done.index(i): v for i, v in SAMPLED.items()
                 if i in done})
    summary = {
        "spec": TP_PREEMPT, "new_tp": stay["new_tp"],
        "reasons": stay["reasons"], "rebuild_s": [stay["rebuild_s"],
                                                  left["rebuild_s"]],
        "ticks_after": stay["ticks_after"], "after": stay["after"],
        "pulls_after": stay["pulls_after"], "dumps": stay["dumps"],
        "retired_rank_has_work": left["has_work"],
        "launches_a_rank": [stay["launches"], left["launches"]],
        "decode_ticks": [stay["decode_ticks"], left["decode_ticks"]],
        "wall_s": [stay["wall_s"], left["wall_s"]],
        "greedy_equal": verdict["greedy_equal"],
        "greedy_requests": verdict["greedy_requests"],
        "sampled_equal": verdict["sampled_equal"],
        "partings": len(verdict["partings"]),
        "verdict": "bit-identical to 5c's paged engine"
        if not verdict["partings"] else "5b's f64 parting verdict"}
    return (stay["launches"] + left["launches"],
            {k: stay["draws"][k] + left["draws"][k] for k in stay["draws"]},
            summary)


def tp_kernel_check(torch, qm, dev):
    """Phase 5e's kernel checks: the int8 kernel at M 8 on every leaf
    shape of a tp2 rank (TP_LEAF_KN), against its plain version (timed
    beside the library and the bound) and against the f64 bound, each
    call on its own input. Returns ({(K, N): row}, the f64 worst)."""
    g = torch.Generator(device=dev).manual_seed(21)
    sm = qm._sm_count(dev)
    worst = {"kernel_max_ulps": 0.0, "kernel_max_bound_share": 0.0,
             "plain_max_ulps": 0.0, "plain_max_bound_share": 0.0}
    rows = {}
    for K, N in dict.fromkeys(TP_LEAF_KN.values()):
        rows[(K, N)] = qmm_row(torch, qm, dev, g, 8, K, N, tag="tp2")
        qmm_f64_row(torch, qm, dev, g, sm, 8, K, N, worst, tag="tp2")
    return rows, worst


def tp_serving(torch, qm, dev, card, cfg, params, k1c):
    """Phase 5e: the int8 Llama engine at TinyLlama widths and
    LLAMA_SERVE_LAYERS layers, tensor-parallel over two spawned ranks
    (a card a rank over NCCL; on one card both share it over gloo, every
    tp collective an all-reduce through the host, so the tick times
    show the host link, not scaling), on 10 of 5b's 16 requests (dense,
    K = 1) and of 5c's (paged with spec decode; TP_REQUESTS), the first
    TP_NEW_TOKENS of each stream. Every request ends "length";
    each rank launches 29 int8 kernels a pass and 89 a spec tick; both
    ranks' streams are identical; each stream equals 5b's (dense) or
    5c's paged spec engine's, or its parting passes 5b's f64 verdict
    along the single-card path. (b) Then each rank runs
    `tp_preempt_drill` (serving_device_loss: TP_PREEMPT degrades tp2 ->
    tp1 through the preempt guard, `rebuild_on_mesh` keeps rank 0's live
    streams, rank 1 retires), judged by `tp_preempt_check` against 5c's
    single-card paged engine. Returns (the int8 kernel's launches
    {path: both ranks'}, the threefry draws {path: ...}, the kernel rows
    at the tp shapes, the summary)."""
    import shutil
    import tempfile
    import torch.multiprocessing as mp
    from paddle_tpu_torch.inference.serving import _to_device
    from paddle_tpu_torch.parallel.planner import plan_serving_tp
    from paddle_tpu_torch.quantization import serving as qs
    t0 = time.perf_counter()
    rows, f64 = tp_kernel_check(torch, qm, dev)
    check_s = time.perf_counter() - t0
    tree = qs.quantize_serving_params(params, "llama")   # quantize_once's
    workdir = tempfile.mkdtemp(prefix="chip_smoke_5e_")
    try:
        t_s = time.perf_counter()
        torch.save(tree, os.path.join(workdir, "int8.pt"))
        save_s = time.perf_counter() - t_s
        t_s = time.perf_counter()
        mp.spawn(_tp_serving_rank, args=(TP, workdir), nprocs=TP, join=True)
        ranks_s = time.perf_counter() - t_s
        ranks = []
        for r in range(TP):
            with open(os.path.join(workdir, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    per_pass = sum(pass_calls(TP_LEAF_KN, cfg.num_layers).values())
    want_shapes = sorted({(k, n) for k, n in TP_LEAF_KN.values()})
    line = {"phase": "llama_tp2_serving", "card": card, "ranks": TP,
            "route": ranks[0]["route"], "layers": cfg.num_layers,
            "launches_per_pass": per_pass,
            "kernel_check_s": check_s, "int8_tree_save_s": save_s,
            "ranks_s": ranks_s, "rank_start_s": [r["start_s"] for r in ranks],
            "f64_tp_shapes": f64,
            "plan_serving_tp": {
                f"{n}_devices": plan_serving_tp(cfg, n, 8, 2048)["tp"]
                for n in (1, 2)},
            "tick_note": "ranks share one card over gloo: every tp "
                         "collective goes through the host, so the tick "
                         "measures the host link, not scaling"}
    launches, draws = {}, {}
    single = {label: [k1c[key]["streams"][i][:TP_NEW_TOKENS]
                      for i in TP_REQUESTS]
              for label, key in (("tp2", "serving"), ("tp2_spec", "spec"))}
    qp = None
    for label, kw, prompts_fn in TP_ENGINES:
        a, b = (r[label] for r in ranks)
        if a["streams"] != b["streams"]:
            raise AssertionError(f"5e {label}: the ranks' streams part")
        got_shapes = sorted({tuple(s[-2:]) for s in a["int8_shapes"]})
        if got_shapes != want_shapes:
            raise AssertionError(f"5e {label}: int8 shards {got_shapes} "
                                 f"are not the tp2 shapes {want_shapes}")
        launches[f"llama_{label}"] = a["launches"] + b["launches"]
        draws[f"llama_{label}"] = {k: a["draws"][k] + b["draws"][k]
                                   for k in a["draws"]}
        prompts = tp_prompts(prompts_fn, cfg.vocab_size)
        if qp is None and a["streams"] != single[label]:
            qp = _to_device(tree[0], dev)
        dense_path = {"layout": "dense"}
        path = (dense_path if label == "tp2" else
                {"layout": "paged", "page_size": 16, "chunk": 256,
                 "window": SPEC["gamma"] + 1})
        verdict = compare_streams(
            torch, qm, qp, cfg, dev, prompts, a["streams"], single[label],
            f"{label}_vs_single_card", ((label, path), ("single", path)),
            sampled={TP_REQUESTS.index(i): v for i, v in SAMPLED.items()
                     if i in TP_REQUESTS})
        line[label] = {k: [r[label][k] for r in ranks] for k in (
            "tick_ms_p50", "tick_ms_p90", "prefill_ms_p50",
            "prefill_ms_max", "max_memory_allocated_bytes",
            "kv_cache_bytes", "build_s", "wall_s", "tokens_per_s")}
        line[label].update({
            "decode_ticks": a["decode_ticks"], "prefills": a["prefills"],
            "prefill_chunks": a["prefill_chunks"],
            "launches_a_rank": [a["launches"], b["launches"]],
            "collectives_per_dispatch": a["collectives_per_dispatch"],
            "kv_cache_shape": a["kv_cache_shape"],
            "greedy_equal": verdict["greedy_equal"],
            "sampled_equal": verdict["sampled_equal"],
            "partings": len(verdict["partings"])})
    # (b) the preempt guard: rank 0 stays at tp1, rank 1 retires
    launches["llama_tp2_preempt"], draws["llama_tp2_preempt"], \
        line["tp2_preempt"] = tp_preempt_check(torch, qm, cfg, dev, ranks,
                                               k1c, tree, qp)
    del qp, tree
    torch.cuda.empty_cache()
    log(json.dumps(line))
    return launches, draws, rows, line


# phase 5d: K ticks a dispatch, each dispatch a CUDA graph replay, and the
# host KV tier
MT_K = 4
TIER = dict(kv_layout="paged", page_size=16, prefill_chunk=256,
            num_pages=257, multi_tick=MT_K)
TIER_BYTES = 256 << 20


@contextlib.contextmanager
def quantize_once():
    """Every serving engine of phases 5b-5d quantizes the same host-drawn
    Llama tree (~10 s on the host each): the int8 rewrite is computed
    once and handed to each build."""
    from paddle_tpu_torch.quantization import serving as qs
    real = qs.quantize_serving_params
    memo = {}

    def once(params, family):
        key = (id(params), family)
        if key not in memo:
            memo[key] = real(params, family)
        return memo[key]
    qs.quantize_serving_params = once
    try:
        yield
    finally:
        qs.quantize_serving_params = real


def multi_tick_serving(torch, qm, dev, card, cfg, params, k1):
    """Phase 5d (a)-(d): the int8 Llama engines of phases 5b and 5c at
    multi_tick=4, each dispatch after each sampling flag's warm-up a
    CUDA graph replay: (a) dense over phase 5b's requests, (b) paged and
    (c) paged spec over phase 5c's, (d) dense spec. Each run's launches
    and replays are checked (`check_launches`), its streams held to the
    K = 1 engine's of the same layout (`k1`: {label: summary with
    streams}) token for token or by phase 5b's verdict at each parting,
    sampled ones too. Returns the int8 kernel's launches {path: n} and
    its launches inside graph replays {path: {"replays": replays x K x
    the tick's calls, "profiled": those the profiler listed over the
    tick profile's replays}}."""
    from paddle_tpu_torch.inference import ServingEngine
    per_pass = sum(pass_calls(LLAMA_LEAF_KN, cfg.num_layers).values())
    draft = sum(pass_calls(LLAMA_LEAF_KN, SPEC["draft_layers"]).values())
    spec_tick = per_pass + SPEC["gamma"] * draft
    dense_path = {"layout": "dense"}
    paged_path = {"layout": "paged", "page_size": 16, "chunk": 256}
    window = SPEC["gamma"] + 1
    launches, replays = {}, {}
    for label, kw, prompts, base, path in (
            ("mt_dense", {"kv_layout": "dense"},
             llama_prompts(cfg.vocab_size), "serving", dense_path),
            ("mt_paged", PAGED, paged_prompts(cfg.vocab_size), "paged",
             paged_path),
            ("mt_spec", dict(PAGED, **SPEC), paged_prompts(cfg.vocab_size),
             "spec", dict(paged_path, window=window)),
            ("mt_dense_spec", dict(kv_layout="dense", **SPEC),
             paged_prompts(cfg.vocab_size), "dense_spec",
             dict(dense_path, window=window))):
        t0 = time.perf_counter()
        eng = ServingEngine(params, cfg, family="llama", num_slots=8,
                            max_len=2048, max_top_k=50, seed=0, quant="int8",
                            multi_tick=MT_K, **kw)
        log(json.dumps({"phase": f"llama_{label}_build",
                        "knobs": dict(kw, multi_tick=MT_K),
                        "seconds": time.perf_counter() - t0}))
        streams, summary, launches[f"llama_{label}"] = run_engine(
            torch, qm, eng, prompts, label, card, per_pass,
            spec_tick if eng.spec else per_pass,
            new_tokens=64 if base == "serving" else PAGED_NEW)
        replays[f"llama_{label}"] = {
            "replays": summary["replay_launches"],
            "profiled": summary["profile"]["replay_launches_profiled"]}
        qp = eng._params
        del eng
        gc.collect()
        torch.cuda.empty_cache()
        ref = k1[base]
        log(json.dumps({
            "phase": f"llama_{label}_vs_k1", "card": card,
            "tokens_per_s": summary["tokens_per_s"],
            "k1_tokens_per_s": ref["tokens_per_s"],
            "tokens_per_s_ratio": summary["tokens_per_s"]
            / ref["tokens_per_s"],
            "dispatch_ms_p50": summary["dispatch_ms_p50"],
            "ms_per_token_tick": summary["ms_per_token_tick"],
            "k1_tick_ms_p50": ref["tick_ms_p50"],
            "k1_from": "phase 5b" if base == "serving" else "phase 5c"}))
        compare_streams(torch, qm, qp, cfg, dev, prompts, streams,
                        ref["streams"], f"{label}_vs_k1",
                        (("k4", path), ("k1", path)),
                        sampled_verdict=True)
        del qp
        torch.cuda.empty_cache()
    return launches, replays


def tier_prompts(vocab):
    """The host tier's traffic (seed 11): 8 prompt families, each a
    512-token prefix of its own plus a 16..256-token suffix, 2 requests a
    family."""
    rng = np.random.default_rng(11)
    prompts = []
    for _ in range(8):
        prefix = rng.integers(0, vocab, size=512)
        for _ in range(2):
            suffix = rng.integers(0, vocab, size=int(rng.integers(16, 257)))
            prompts.append(np.concatenate([prefix, suffix]))
    return prompts


def host_tier_serving(torch, qm, dev, card, cfg, params):
    """Phase 5d (e): the paged multi-tick engine with 257 pages (a page's
    K+V is L x 16 x 4 x 64 x 2 x 2 B, 65,536 at 4 layers, and the 8
    prefixes alone take 256 pages, so the pool cannot keep them while
    slots run)
    serves `tier_prompts` twice, 32 new tokens each, greedy: with a 256
    MiB host tier, without it, and with a pool of 1025 pages that keeps
    every page on the device. Checks: spills and swap-ins > 0, the tier
    engine's streams equal the 1025-page engine's token for token (a
    swapped-in page reads as a device hit would) and the tier-less
    engine's or each parting passes phase 5b's verdict, the pool after
    every step, the launches. Prints bytes, drops, ms a swapped-in page
    (CUDA events over uploads of the tier's pages onto the scratch
    page), the round-2 chunks and prefill p50 of each engine. Returns
    the int8 kernel's launches through the wrapper and inside graph
    replays (replays x K x the tick's calls)."""
    from paddle_tpu_torch.inference import ServingEngine
    from paddle_tpu_torch.kernels import threefry as tf
    prompts = tier_prompts(cfg.vocab_size)
    per_pass = sum(pass_calls(LLAMA_LEAF_KN, cfg.num_layers).values())
    out, launches, replays = {}, 0, 0
    for label, kw in (("tier", dict(TIER, host_kv_bytes=TIER_BYTES)),
                      ("no_tier", TIER),
                      ("device_pool", dict(TIER, num_pages=1025))):
        eng = ServingEngine(params, cfg, family="llama", num_slots=8,
                            max_len=2048, seed=0, quant="int8", **kw)
        warm = count_warmups(torch, qm, eng)
        rounds = []
        for rnd in range(2):
            c0 = dict(eng.counters)
            n_pf0 = len(eng.prefill_ms)
            qm.launches = 0
            cap0 = qm.captured
            tf.launches["threefry_bits"] = 0
            tf_cap0 = tf.captured
            t0 = time.perf_counter()
            reqs = [eng.submit(p, 32) for p in prompts]
            while eng.has_work():
                eng.step()
                pool_check(eng)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            c = {k: v - c0[k] for k, v in eng.counters.items()}
            check_launches(eng, f"tier {label} round {rnd}", c,
                           qm.launches, per_pass, per_pass, warm,
                           qm.captured - cap0)
            check_draws(eng, f"tier {label} round {rnd}", c,
                        tf.launches["threefry_bits"], tf.captured - tf_cap0)
            del warm[:]
            launches += qm.launches
            replays += c["graph_replays"] * eng.mt_k * per_pass
            if any(r.finish_reason != "length" for r in reqs):
                raise AssertionError(f"tier {label}: finish reasons")
            pf = list(eng.prefill_ms)[n_pf0:]
            rounds.append({"streams": [list(r.tokens) for r in reqs],
                           "wall_s": wall, "chunks": c["prefill_chunks"],
                           "prefix_hit_pages": c["prefix_hits"],
                           "dispatches": c["decode_ticks"],
                           "prefill_ms_p50": statistics.median(pf)})
        st = eng.pool_stats()
        line = {"phase": f"llama_tier_{label}", "card": card,
                "knobs": {k: v for k, v in kw.items()},
                "rounds": [{k: v for k, v in r.items() if k != "streams"}
                           for r in rounds],
                "pool": st}
        if label == "tier":
            tier = eng._host_tier
            pairs = [tier.get(key) for key in list(tier._d)[:64]]

            def swap_in():
                for pair in pairs:
                    for name, page in zip(("k", "v"),
                                          eng._upload_pair(pair)):
                        eng._cache[name][:, 0].copy_(page)   # scratch
            line["swapin_ms_per_page"] = event_ms(torch, swap_in,
                                                  3) / len(pairs)
            line["swapin_timed"] = ("CUDA events over 3 x 64 pinned "
                                    "uploads and in-place page copies")
            led = eng.memory_ledger()
            line["ledger"] = {"kv_pool_host": led["components"][
                "kv_pool_host"], "device_total": led["total"]}
            if not (st["host_tier"]["spills"] and st["host_tier"]["swapins"]):
                raise AssertionError(f"host tier: no spill or swap-in: {st}")
            if led["components"]["kv_pool_host"] != st["host_tier"]["bytes"]:
                raise AssertionError("host tier: the ledger's kv_pool_host "
                                     "is not the tier's bytes")
        log(json.dumps(line))
        out[label] = rounds
        qp = eng._params
        del eng, reqs       # a Request holds its engine
        gc.collect()
        torch.cuda.empty_cache()
    paged_path = {"layout": "paged", "page_size": 16, "chunk": 256}
    for rnd in range(2):
        compare_streams(torch, qm, qp, cfg, dev, prompts,
                        out["tier"][rnd]["streams"],
                        out["device_pool"][rnd]["streams"],
                        f"tier_vs_device_pool_round{rnd + 1}",
                        (("tier", paged_path), ("device_pool", paged_path)),
                        sampled=(), strict=True)
        compare_streams(torch, qm, qp, cfg, dev, prompts,
                        out["tier"][rnd]["streams"],
                        out["no_tier"][rnd]["streams"],
                        f"tier_vs_no_tier_round{rnd + 1}",
                        (("tier", paged_path), ("no_tier", paged_path)),
                        sampled=())
    del qp
    torch.cuda.empty_cache()
    return launches, replays


# phase 6: the planner-driven dp×fsdp×tp train step at phase 4's
# configuration, 6a on one rank and 6b on two (SHARDED_PLANS)
# each leaf's step-1 gradient norm on two ranks against the unsharded
# one's: |ratio - 1| at most this (PERF.md §5)
GRAD_NORM_TOL = 1e-2


def lazy_opt_state(torch, params):
    """init_opt_state's tree for full `params`, its moments zero-stride
    views: a sharded step's shard_args materializes only the rank's
    block of each."""
    dev = next(iter(params.values())).device
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    return {"m": {k: zero.expand(p.shape) for k, p in params.items()},
            "v": {k: zero.expand(p.shape) for k, p in params.items()},
            "step": torch.zeros((), dtype=torch.float32, device=dev)}


def state_bytes(params, opt):
    """Device bytes of the params and both moment trees."""
    return sum(t.numel() * t.element_size()
               for tree in (params, opt["m"], opt["v"]) for t in tree.values())


def timed_losses(torch, step, params, opt, tokens, n):
    """n steps, each timed on the host clock up to its loss's pull."""
    losses, ms = [], []
    for _ in range(n):
        t_s = time.perf_counter()
        losses.append(float(step(params, opt, tokens)[0]))
        ms.append((time.perf_counter() - t_s) * 1e3)
    return losses, ms


# 6a's device telemetry (paddle_tpu_torch/profiler/telemetry.py): the 5
# trajectory steps through instrument_train_step, a flush every
# TELE_EVERY steps (one flush and the tail on close)
TELE_EVERY = 4
# the recorded grad_norm (the Adam moment identity (sum v' - b2 sum v) /
# (1 - b2), each sum an f32 reduction over the 1.03 G moments) against
# an f64 norm of the gradient at the same state: at the 5th update the
# two sums are ~0.23 and ~0.18 of the gradients' squares, so the
# difference amplifies each sum's relative error ~8x; an f32 tree
# reduction's is <= 2e-6 here, the norm's (half the sum's) <= 1e-5 -
# held to 10x that. The param norm's one f32 reduction a leaf: 1e-5.
GRAD_NORM_ID_TOL = 1e-4
PARAM_NORM_TOL = 1e-5
# train.mfu (its window: the flush after step 3 to the tail's pull after
# step 4) against the MFU of step 4 on the host clock, the step that
# window timed; phase 4's MFU and the 5 plain steps' are printed beside
# it. A reference that times other steps misses by the step-to-step
# spread: one run read 333-445 ms for the same step (PERF.md)
MFU_TOL = 0.15
# a batch that exhausts the card during the forward: at 256 x 2048 the
# remat inputs alone (22 layers x 4.3 GB) exceed 80 GB, and no kernel
# operand passes 2^31 elements (q is 1.07 G), so the error is the
# allocator's and the card stays usable
OOM_BATCH = 256


@contextlib.contextmanager
def paused_counts():
    """Launches inside the body are not counted: every train kernel's
    counter is put back as it was (a check's own call is not the main
    path's)."""
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import fused_ce as fce
    from paddle_tpu_torch.kernels import fused_update as fu
    saved = [(c, dict(c)) for c in (fa.launches, fce.launches, fu.launches)]
    try:
        yield
    finally:
        for counts, was in saved:
            counts.update(was)


def count_syncs(torch, fn):
    """fn() under torch.cuda.set_sync_debug_mode("warn"): (its result,
    the first line of each synchronizing call's warning)."""
    import warnings
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return out, [str(w.message).splitlines()[0][:160] for w in seen
                 if "called a synchronizing" in str(w.message)]


def f64_norm(torch, tree):
    """The global norm of a tree's tensors, each leaf summed in f64."""
    return math.sqrt(sum(float(torch.sum(torch.square(t.double())))
                         for t in tree.values()))


def trace_names(path):
    """Every event name of a chrome-trace JSON file."""
    with open(path) as f:
        return {e.get("name", "") for e in json.load(f)["traceEvents"]}


def sharded_one_rank(torch, dev, card, p4):
    """Phase 6a: the sharded step on a 1-rank NCCL group, plan
    dp1×fsdp1×tp1, at phase 4's configuration from phase 4's starting
    state (seed 0, drawn again), the fused AdamW forced and the CE on
    its default route. Its 5 trajectory steps go through
    profiler/telemetry.py's instrument_train_step (MFU_FIELDS, a flush
    every TELE_EVERY steps, flops_per_token from
    cost_model.train_flops_per_token), the build and step 0 under the
    port's Profiler. Checked: the 5 losses equal phase 4's kernel
    trajectory to the bit; launches per step phase 4's exactly; exactly
    2 pulls (the flush and the tail on close); every recorded loss the
    step's; nonfinite 0; the recorded param_norm within PARAM_NORM_TOL of
    an f64 norm of the params, and grad_norm within GRAD_NORM_ID_TOL of
    the f64 norm of step.loss_and_grads at the state before step 4 (the
    check's launches not counted); as many synchronizing calls in an
    instrumented step as in a plain one (set_sync_debug_mode); train.mfu
    within MFU_TOL of step 4's MFU on the host clock, the step its window
    timed (the plain steps' and phase 4's printed beside it);
    tools/telemetry_report.py reads the
    stream; the Profiler's trace names the three flash kernels and the
    facade.make_train_step span. 5 plain steps give its p50 beside phase
    4's. Then one OOM_BATCH x LLAMA_SEQ batch through a fresh step must
    raise torch.OutOfMemoryError, leave an oom_forensics flight dump
    naming every params and moment leaf, and leave
    torch.cuda.memory_allocated() as it was. Returns its losses,
    launches, state bytes, peak and p50."""
    import shutil
    import tempfile
    import torch.distributed as dist
    from paddle_tpu_torch.cost_model import train_flops_per_token
    from paddle_tpu_torch.models import llama
    from paddle_tpu_torch.models.facade import make_train_step
    from paddle_tpu_torch.parallel import (collective_route,
                                           init_parallel_env, plan_train)
    from paddle_tpu_torch.profiler import (Profiler, flight_recorder,
                                           monitor, telemetry)
    sys.path.insert(0, os.path.join(HERE, "tools"))
    from telemetry_report import summarize
    cfg = llama.LlamaConfig(**LLAMA, remat=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_6a_")
    rec = flight_recorder.recorder()
    saved_rec = (rec.dir, rec.autodump_every)
    rec.set_dir(os.path.join(work, "flight"))
    rec.autodump_every = 0
    orig_pull = telemetry._host_pull
    pulls = []
    telemetry._host_pull = lambda x: (pulls.append(1), orig_pull(x))[1]
    init_parallel_env(backend="nccl", world_size=1)
    tl = {"phase": "llama_sharded_1rank_telemetry", "card": card,
          "every": TELE_EVERY}
    try:
        plan = plan_train(cfg, 1, LLAMA_BATCH, dp=1, fsdp=1, tp=1)
        mesh = plan.build_mesh()
        host = dict(llama_full_host())           # read only: shard_args
        tokens = train_tokens(torch, dev, cfg, LLAMA_BATCH, LLAMA_SEQ, 3)
        fpt = train_flops_per_token(sum(p.numel() for p in host.values()),
                                    cfg.num_layers, cfg.hidden_size,
                                    LLAMA_SEQ)
        path = os.path.join(work, "telemetry.jsonl")
        tele = telemetry.TelemetryPipeline(
            path, every=TELE_EVERY, fields=telemetry.MFU_FIELDS,
            flops_per_token=fpt, meta={"samples_per_step": LLAMA_BATCH,
                                       "card": card})
        losses, traj_ms, oracle = [], [], {}
        with forced_registry(fused_update="pallas"):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            zero_launch_counts()                  # the main path starts
            prof = Profiler(scheduler=(0, 1),
                            trace_dir=os.path.join(work, "trace")).start()
            step = telemetry.instrument_train_step(
                llama.train_step, tele, cfg=cfg, mesh=mesh, plan=plan,
                **ADAMW)
            ts = tele.device_init(device=dev)
            params, opt, _ = step.shard_args(
                host, lazy_opt_state(torch, host), tokens)
            del host
            for i in range(5):
                t_s = time.perf_counter()
                if i == 2:                        # not a flush step
                    loss, tl["syncs_instrumented"] = count_syncs(
                        torch, lambda: float(step(params, opt, tokens,
                                                  ts)[0]))
                else:
                    loss = float(step(params, opt, tokens, ts)[0])
                traj_ms.append((time.perf_counter() - t_s) * 1e3)
                losses.append(loss)
                if i == 0:
                    prof.step()                   # the trace ends
                if i == 3:
                    # the state before step 4, before the flush that opens
                    # train.mfu's window; its launches and memory not
                    # the main path's
                    peak = torch.cuda.max_memory_allocated()
                    with paused_counts():
                        _, grads = step.loss_and_grads(params, tokens)
                        oracle["grad_norm_f64"] = f64_norm(torch, grads)
                        del grads
                    torch.cuda.reset_peak_memory_stats()
                tele.tick(i, ts)
            tele.close(ts)                        # the MFU window ends
            launches = launch_counts()            # ... and the main path
            peak = max(peak, torch.cuda.max_memory_allocated())
            oracle["param_norm_f64"] = f64_norm(torch, params)
            prof.stop()
            plain = make_train_step(llama.train_step, cfg=cfg, mesh=mesh,
                                    plan=plan, **ADAMW)
            plain.adopt_shapes(params, opt)
            _, step_ms = timed_losses(torch, plain, params, opt, tokens, 5)
            _, tl["syncs_plain"] = count_syncs(
                torch, lambda: float(plain(params, opt, tokens)[0]))
        tl["pulls"] = len(pulls)
        telemetry._host_pull = orig_pull
        recs = [json.loads(ln) for ln in open(path)]
        rows = [r for r in recs if r["kind"] == "step"]
        tl["rows"] = rows
        tl["mfu"] = monitor.gauge("train.mfu").value
        tl["tokens_per_s"] = monitor.gauge("train.tokens_per_s").value
        tl["phase4_mfu"] = p4["train"]["mfu"]
        tl["plain_mfu"] = fpt * LLAMA_BATCH * LLAMA_SEQ / (
            statistics.median(step_ms) / 1e3) / PEAK_BF16_FLOPS
        tl["step4_mfu"] = fpt * LLAMA_BATCH * LLAMA_SEQ / (
            traj_ms[4] / 1e3) / PEAK_BF16_FLOPS
        last = rows[-1]
        tl.update(oracle)
        tl["grad_norm_rel"] = abs(last["grad_norm"] / oracle[
            "grad_norm_f64"] - 1)
        tl["param_norm_rel"] = abs(last["param_norm"] / oracle[
            "param_norm_f64"] - 1)
        report = summarize(path)
        tl["report"] = {k: report.get(k) for k in (
            "runs", "steps_recorded", "flushes", "bad_lines", "bad_steps",
            "mfu", "step_time")}
        names = trace_names(prof.trace_paths[0])
        tl["trace_events"] = len(names)
        tl["trace_has"] = {k: any(k in n for n in names) for k in (
            "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
            "facade.make_train_step")}
        # out of memory in the forward of a fresh step
        big = train_tokens(torch, dev, cfg, OOM_BATCH, LLAMA_SEQ, 4)
        oom = make_train_step(llama.train_step, cfg=cfg, mesh=mesh,
                              plan=plan, **ADAMW)
        oom.adopt_shapes(params, opt)
        n_oom = monitor.counter("train.oom_forensics").value
        gc.collect()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        t_s = time.perf_counter()
        raised = None
        try:
            oom(params, opt, big)
        except torch.OutOfMemoryError as e:
            raised = str(e).splitlines()[0][:200]
        tl["oom_s"] = time.perf_counter() - t_s
        gc.collect()
        torch.cuda.synchronize()
        # the telemetry's reads of the state on their own, on the device:
        # the second moments' sum (taken before and after an update),
        # the params' norm and non-finite count, as a step makes them
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        for _ in range(3):
            for _ in range(2):
                telemetry.moment_sums(opt)
            telemetry._sumsq(params)
            telemetry._nonfinite(params)
        ev[1].record()
        torch.cuda.synchronize()
        tl["scalars_device_ms"] = ev[0].elapsed_time(ev[1]) / 3
        # the least: the params and the moments before and after read
        # once each (the reads run the params twice, for the norm and the
        # count, and write a byte a parameter)
        tl["scalars_bound_ms"] = 3 * state_bytes(
            params, {"m": {}, "v": {}}) / PEAK_BYTES * 1e3
        flight = os.path.join(work, "flight")
        dumps = sorted(f for f in os.listdir(flight)
                       if f.endswith("-oom_forensics.json"))
        fo = flight_recorder.load_dump(os.path.join(flight, dumps[0])) \
            ["config"]["oom_forensics"] if dumps else {}
        tl["oom"] = {
            "batch": [OOM_BATCH, LLAMA_SEQ], "raised": raised,
            "counted": monitor.counter("train.oom_forensics").value - n_oom,
            "dumps": dumps, "allocated_before": before,
            "allocated_after": torch.cuda.memory_allocated(),
            "ledger_total": (fo.get("ledger") or {}).get("total"),
            "live_bytes": fo.get("live_bytes"),
            "other_bytes": fo.get("other_bytes"),
            "leaves": sorted({leaf for row in fo.get("census", {}).values()
                              for leaf in row["leaves"]})}
        nbytes = state_bytes(params, opt)
        backend, route = str(dist.get_backend()), collective_route(None, dev)
        del step, plain, oom, params, opt, tokens, big, ts
    finally:
        telemetry._host_pull = orig_pull
        rec.clear()
        rec.set_dir(saved_rec[0])
        rec.autodump_every = saved_rec[1]
        dist.destroy_process_group()
        shutil.rmtree(work, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    log(json.dumps(tl))
    want4 = p4["trajectory"]
    per_step = {k: v // 5 for k, v in launches.items()}
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, want4)]
    line = {"phase": "llama_sharded_1rank", "card": card,
            "plan": plan.name, "backend": backend, "route": route,
            "losses": losses, "phase4_losses": want4, "rel_diff": rel,
            "bitwise_equal": losses == want4,
            "launches": launches, "launches_per_step": per_step,
            "phase4_launches_per_step": p4["train"]["launches_per_step"],
            "trajectory_ms": traj_ms,
            "step_ms": step_ms, "step_ms_p50": statistics.median(step_ms),
            "phase4_step_ms_p50": p4["train"]["step_ms_p50"],
            "state_bytes": nbytes, "max_memory_allocated_bytes": peak,
            "phase4_max_memory_allocated_bytes":
                p4["train"]["max_memory_allocated_bytes"]}
    log(json.dumps(line))
    if losses != want4:
        raise AssertionError(f"6a: losses {losses} != phase 4's {want4}")
    if per_step != p4["train"]["launches_per_step"] or any(
            v % 5 for v in launches.values()):
        raise AssertionError(f"6a: launches {launches} over 5 steps, phase "
                             f"4 {p4['train']['launches_per_step']} a step")
    bad = []
    if tl["pulls"] != 2:
        bad.append(f"{tl['pulls']} pulls, not 2")
    if [r["step"] for r in rows] != list(range(5)) or \
            [r["loss"] for r in rows] != losses:
        bad.append("the recorded losses are not the steps'")
    if any(r["nonfinite"] != 0 for r in rows) or any(
            r["tokens"] != LLAMA_BATCH * LLAMA_SEQ for r in rows):
        bad.append("nonfinite or tokens")
    if tl["param_norm_rel"] > PARAM_NORM_TOL:
        bad.append(f"param_norm {tl['param_norm_rel']}")
    if tl["grad_norm_rel"] > GRAD_NORM_ID_TOL:
        bad.append(f"grad_norm {tl['grad_norm_rel']}")
    if len(tl["syncs_instrumented"]) != len(tl["syncs_plain"]):
        bad.append("the instrumented step synchronizes more")
    if not abs(tl["mfu"] / tl["step4_mfu"] - 1) <= MFU_TOL:
        bad.append(f"train.mfu {tl['mfu']} vs step 4's {tl['step4_mfu']} "
                   f"(the plain steps' {tl['plain_mfu']}, phase 4's "
                   f"{tl['phase4_mfu']})")
    r = tl["report"]
    if (r["steps_recorded"], r["flushes"], r["bad_lines"]) != (5, 2, 0) or \
            not (r.get("mfu") or {}).get("mfu"):
        bad.append(f"telemetry_report: {r}")
    if not all(tl["trace_has"].values()):
        bad.append(f"the Profiler's trace lacks {tl['trace_has']}")
    o = tl["oom"]
    want_leaves = {f"params/{k}" for k in LLAMA_LEAVES} | {
        f"opt_state/{m}/{k}" for m in ("m", "v") for k in LLAMA_LEAVES}
    if o["raised"] is None or o["counted"] != 1 or len(o["dumps"]) != 1 \
            or o["allocated_after"] != o["allocated_before"] or \
            not want_leaves <= set(o["leaves"]) or not o["ledger_total"]:
        bad.append(f"oom_forensics: {o}")
    if bad:
        raise AssertionError(f"6a telemetry: {bad}")
    return {"losses": losses, "per_step": per_step, "state_bytes": nbytes,
            "peak": peak, "step_ms_p50": line["step_ms_p50"],
            "launches": launches}


def handoff_profile(torch, step, params, opt, tokens):
    """One more step of the pipelined `step` with every stage handoff
    (parallel/collective.py `exchange`, as pipeline_train calls it)
    timed on the host clock between two synchronizes, so that the card
    is idle at each mark: the step's ms, each slot's handoff ms and the
    compute ms before it (from the previous mark), their sums, and the
    share of the step spent inside handoffs (this rank's measured idle
    share: waiting for its peer's slot at the rendezvous, plus the
    transfers)."""
    from paddle_tpu_torch.parallel import pipeline_train as ptr
    exchange, marks = ptr.exchange, []

    def timed(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = exchange(*args, **kw)
        torch.cuda.synchronize()
        marks.append((t0, time.perf_counter()))
        return out
    torch.cuda.synchronize()
    t_s = time.perf_counter()
    ptr.exchange = timed
    try:
        float(step(params, opt, tokens)[0])
    finally:
        ptr.exchange = exchange
    step_ms = (time.perf_counter() - t_s) * 1e3
    handoff = [(b - a) * 1e3 for a, b in marks]
    before = [(a - p) * 1e3 for a, p in zip(
        [m[0] for m in marks], [t_s] + [m[1] for m in marks[:-1]])]
    return {"step_ms": step_ms, "handoffs": len(marks),
            "handoff_ms": handoff, "compute_ms_before": before,
            "handoff_ms_sum": sum(handoff),
            "rest_ms": step_ms - sum(handoff),
            "handoff_share": sum(handoff) / step_ms}


def disk_check(path, need, label):
    """Free bytes under `path` (shutil.disk_usage, printed); fails, with
    both numbers, when fewer than the `need` bytes the phase will
    write."""
    import shutil
    free = shutil.disk_usage(path).free
    log(json.dumps({"phase": f"{label}_disk", "dir": path,
                    "free_bytes": free, "will_write_bytes": need}))
    if free < need:
        raise AssertionError(f"{label}: {free} B free under {path}, the "
                             f"phase writes {need} B")
    return free


def state_marginals(torch, pins, params, opt, world):
    """6c (b)'s fingerprint of a sharded state, independent of the
    checkpoint code: for each params, m and v leaf and each of its dims,
    the sum of x² over the other dims at every global index of that dim
    (f64 sums of f32 squares), from this rank's block placed at its
    offset in the full leaf (the pin's local_index) and divided by the
    number of ranks holding the same block, so the ranks' vectors add up
    to the full leaf's under any plan (a halving is exact). A stage's
    layers swapped, a block at the wrong offset, or another step's
    state moves it. Returns {key: [one list a dim]}."""
    out = {}
    for name, tree, tpins in (("params", params, pins[0]),
                              ("m", opt["m"], pins[1]["m"]),
                              ("v", opt["v"], pins[1]["v"])):
        for k, t in tree.items():
            idx = tpins[k].local_index()
            holders = world // math.prod(n for _, n in idx)
            sq = t.detach().float().square()
            rows = []
            for d in range(t.dim()):
                i, n = idx[d] if d < len(idx) else (0, 1)
                size = t.shape[d]
                others = [e for e in range(t.dim()) if e != d]
                part = (sq.sum(dim=others, dtype=torch.float64) if others
                        else sq.double())
                full = torch.zeros(size * n, dtype=torch.float64)
                full[i * size:(i + 1) * size] = part.cpu() / holders
                rows.append(full.tolist())
            out[f"{name}/{k}"] = rows
            del sq
    return out


def summed_marginals(parts):
    """The ranks' state_marginals added up: the full leaves'."""
    out = {}
    for part in parts:
        for key, rows in part.items():
            have = out.setdefault(key, [np.zeros(len(r)) for r in rows])
            for acc, r in zip(have, rows):
                acc += np.asarray(r)
    return out


def rank_save(torch, step, params, opt, mgr, at):
    """6c (b): this rank's part of a synchronous save of the sharded
    state after step `at` (each rank its replica-0 blocks, one commit).
    Returns the seconds, the bytes this rank wrote, the free disk and
    the state's marginals (state_marginals)."""
    import shutil
    free = disk_check(mgr.root, 3 * 4 * sum(
        math.prod(s) for s in llama_leaves(SHARDED_LAYERS).values()),
        "llama_ckpt_6c_b")
    torch.cuda.synchronize()
    t_s = time.perf_counter()
    path = mgr.save({"params": params, "opt_state": opt,
                     "step": np.int64(at)}, at,
                    shardings={"params": step.in_pins[0],
                               "opt_state": step.in_pins[1]})
    secs = time.perf_counter() - t_s
    import torch.distributed as dist
    with open(os.path.join(path, "manifest.json")) as f:
        leaves = json.load(f)["leaves"]
    mine = f".s{dist.get_rank()}.npy"
    written = sum(sh["bytes"] for e in leaves.values()
                  if e["kind"] == "array" for sh in e["shards"]
                  if sh["file"].endswith(mine))
    total = sum(sh["bytes"] for e in leaves.values()
                if e["kind"] == "array" for sh in e["shards"])
    return {"save_s": secs, "bytes_written": written,
            "checkpoint_bytes": total, "free_before": free,
            "free_after": shutil.disk_usage(mgr.root).free, "path": path,
            "marginals": state_marginals(torch, step.in_pins, params, opt,
                                         dist.get_world_size())}


def rank_resume(torch, step, plan, mgr, tokens, host):
    """6c (b): the snapshot restored onto this rank's plan (`plan`'s
    specs: under pp2 a stage's half of every stacked leaf), the step
    pinned from the full shapes, RESUME_STEPS steps on it. Rank 0 then
    deletes the snapshot (both ranks hold it in memory once their first
    step's collectives meet). Returns the losses, step times, restore
    seconds, restored step, the restored optimizer step and the restored
    state's marginals (state_marginals, taken before the steps update
    it in place)."""
    import torch.distributed as dist
    from paddle_tpu_torch.parallel.resilience import plan_state_specs
    torch.cuda.synchronize()
    t_s = time.perf_counter()
    state, at = mgr.restore(mesh=step.mesh, specs=plan_state_specs(plan))
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t_s
    shapes = {k: tuple(v.shape) for k, v in host.items()}
    step.adopt_shapes(shapes, {"m": shapes, "v": shapes, "step": ()})
    local = {k: list(v.shape) for k, v in state["params"].items()}
    marginals = state_marginals(torch, step.in_pins, state["params"],
                                state["opt_state"], dist.get_world_size())
    opt_step = float(state["opt_state"]["step"])
    losses, ms = timed_losses(torch, step, state["params"],
                              state["opt_state"], tokens, RESUME_STEPS)
    if dist.get_rank() == 0:
        import shutil
        shutil.rmtree(mgr.root, ignore_errors=True)
    del state
    torch.cuda.empty_cache()
    return {"losses": losses, "step_ms": ms, "restore_s": restore_s,
            "restored_step": at, "shard_shapes": local,
            "opt_step": opt_step, "marginals": marginals}


def unsharded_reference(torch, llama, cfg, params, tokens):
    """Phase 6b's reference, on rank 0: the unsharded Llama step at 6b's
    configuration from `params` (full, on the card; trained in place), 5
    steps on `tokens` with the fused AdamW forced, as phase 4's
    trajectory runs them. Returns the losses, the launches a step, the
    state bytes, the peak and the steps' host ms p50."""
    from paddle_tpu_torch.models.gpt import init_opt_state
    opt = init_opt_state(params)
    with forced_registry(fused_update="pallas"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_launch_counts()
        losses, ms = [], []
        for _ in range(5):
            t_s = time.perf_counter()
            losses.append(float(llama.train_step(params, opt, tokens, cfg,
                                                 **ADAMW)[0]))
            ms.append((time.perf_counter() - t_s) * 1e3)
        launches = launch_counts()
    ref = {"losses": losses,
           "per_step": {k: v // 5 for k, v in launches.items()},
           "launches": launches, "state_bytes": state_bytes(params, opt),
           "peak": torch.cuda.max_memory_allocated(),
           "step_ms_p50": statistics.median(ms)}
    del opt
    return ref


# phase 6b's GPT plans in the same two-rank world, at SHARDED_LAYERS and
# the headline widths, on hand-built meshes (the planner plans no 'ep'
# or 'sp'): (mesh axes, GPTConfig fields); each held to the unsharded
# step of its config with context_parallel "none", for GPT_PLAN_STEPS
# steps (5 for the Llama plans)
GPT_PLANS = {"ep2": ({"ep": 2}, dict(MOE)),
             "sp2_ring": ({"sp": 2}, {"context_parallel": "ring"}),
             "sp2_ulysses": ({"sp": 2}, {"context_parallel": "ulysses"})}
GPT_PLAN_STEPS = 2
GPT_PLAN_ATTN = {"ep2": ATTN_MAIN, "sp2_ring": None,
                 "sp2_ulysses": SHARDED_ATTN["gpt_sp2_ulysses"]}


def gpt_plan_shapes(name):
    """{leaf: the shape of a rank's shard} of the GPT tree of 6b's plan
    `name` at SHARDED_LAYERS: each dim divided by the sizes of the
    plan's mesh axes that models/gpt.py's PARAM_SPECS names for it,
    where they divide it (models/facade.py mesh_plan; these meshes have
    no 'mp' or 'pp'). check_gpt_plans holds every rank's shards to
    it."""
    from paddle_tpu_torch.models.gpt import PARAM_SPECS
    axes, fields = GPT_PLANS[name]
    out = {}
    for leaf, shape in gpt_leaves(SHARDED_LAYERS,
                                  fields.get("num_experts", 0)).items():
        local = list(shape)
        for d, entry in enumerate(PARAM_SPECS[leaf]):
            names = entry if isinstance(entry, tuple) else (entry,)
            n = math.prod(axes.get(a, 1) for a in names if a)
            if local[d] % n == 0:
                local[d] //= n
        out[leaf] = tuple(local)
    return out


def gpt_plan_cfg(name):
    from paddle_tpu_torch.models import gpt
    return gpt.GPTConfig(**dict(FULL, num_layers=SHARDED_LAYERS),
                         remat=True, remat_policy="full",
                         **GPT_PLANS[name][1])


def _arg_bytes(name, args):
    """Bytes a rank hands to one torch.distributed call."""
    import torch.distributed as dist

    def nbytes(t):
        return t.numel() * t.element_size()
    if name in ("all_reduce", "isend"):
        return nbytes(args[0])
    if name in ("all_gather", "all_to_all_single"):
        return nbytes(args[1])
    if name == "reduce_scatter":
        return sum(nbytes(t) for t in args[1])
    if name == "batch_isend_irecv":
        return sum(nbytes(op.tensor) for op in args[0]
                   if op.op is dist.isend)
    return 0


@contextlib.contextmanager
def collective_bytes():
    """{"calls", "bytes"}: the torch.distributed calls made inside the
    body and the bytes this rank handed to them (a receive counts none)."""
    import torch.distributed as dist
    names = ("all_reduce", "all_gather", "reduce_scatter",
             "all_to_all_single", "isend", "irecv", "batch_isend_irecv")
    count = {"calls": 0, "bytes": 0}
    saved = {n: getattr(dist, n) for n in names}

    def counted(name, fn):
        def call(*args, **kw):
            count["calls"] += 1
            count["bytes"] += _arg_bytes(name, args)
            return fn(*args, **kw)
        return call
    for n, fn in saved.items():
        setattr(dist, n, counted(n, fn))
    try:
        yield count
    finally:
        for n, fn in saved.items():
            setattr(dist, n, fn)


def gpt_reference(torch, gpt, cfg, host, tokens, dev):
    """Rank 0's unsharded GPT step of `cfg` from `host`: step 1's loss and
    gradients (their norms, and the gradients themselves pinned on the
    host), then GPT_PLAN_STEPS steps with the fused update forced and
    their launches a step."""
    full = {k: v.to(dev, copy=True) for k, v in host.items()}
    with forced_registry(fused_update="pallas"):
        loss1, grads = gpt.loss_and_grads(full, tokens, cfg)
        norms = {k: float(g.double().norm()) for k, g in grads.items()}
        grads = {k: torch.empty(g.shape, dtype=g.dtype,
                                pin_memory=True).copy_(g)
                 for k, g in grads.items()}
        opt = gpt.init_opt_state(full)
        zero_launch_counts()
        losses, ms = timed_losses(torch, lambda p, o, t: gpt.train_step(
            p, o, t, cfg, **ADAMW), full, opt, tokens, GPT_PLAN_STEPS)
        launches = launch_counts()
    del full, opt
    torch.cuda.empty_cache()
    return {"step1_loss": float(loss1), "norms": norms, "grads": grads,
            "losses": losses, "step_ms": ms,
            "per_step": {k: v // GPT_PLAN_STEPS
                         for k, v in launches.items()}}


def gpt_sharded_plans(torch, rank, dev):
    """Phase 6b's GPT plans on this rank (GPT_PLANS): rank 0 first runs
    each config's unsharded step (gpt_reference); then each plan's step
    1 (rank 0 gathers its gradients whole for the cosines and norm
    ratios), and GPT_PLAN_STEPS steps with the launches counted, the
    kernels' shapes recorded and the collective bytes a step read."""
    import dataclasses
    import torch.distributed as dist
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.models.facade import make_train_step
    from paddle_tpu_torch.parallel import build_mesh
    tokens = train_tokens(torch, dev, gpt_plan_cfg("ep2"), TRAIN_BATCH,
                          TRAIN_SEQ, 6)
    hosts, refs, out = {}, {}, {}
    for name in GPT_PLANS:
        key = "moe" if "num_experts" in GPT_PLANS[name][1] else "dense"
        if key not in hosts:
            cfg = dataclasses.replace(gpt_plan_cfg(name),
                                      context_parallel="none")
            hosts[key] = gpt.init_gpt_params(cfg, seed=0, device="cpu")
            if rank == 0:
                t_s = time.perf_counter()
                refs[key] = gpt_reference(torch, gpt, cfg, hosts[key],
                                          tokens, dev)
                refs[key]["seconds"] = time.perf_counter() - t_s
    dist.barrier()
    for name, (axes, _) in GPT_PLANS.items():
        key = "moe" if "num_experts" in GPT_PLANS[name][1] else "dense"
        cfg, host = gpt_plan_cfg(name), hosts[key]
        t_s = time.perf_counter()
        step = make_train_step(gpt.train_step, cfg=cfg,
                               mesh=build_mesh(axes), **ADAMW)
        params, opt, _ = step.shard_args(host, lazy_opt_state(torch, host),
                                         tokens)
        row = {"axes": axes, "leaves": len(params),
               "shard_shapes": {k: list(v.shape) for k, v in
                                params.items()}}
        with forced_registry(fused_update="pallas"):
            loss1, grads = step.loss_and_grads(params, tokens)
            full = step.gather_full(grads)
            del grads
            row["step1_loss"] = float(loss1)
            if rank == 0:
                ref = refs[key]
                row["cosine_by_leaf"] = {
                    k: _cos(full[k], ref["grads"][k].to(dev)) for k in full}
                row["norm_ratio_by_leaf"] = {
                    k: float(full[k].double().norm()) / ref["norms"][k]
                    for k in full}
            del full
            torch.cuda.empty_cache()
            with kernel_shapes() as shapes, collective_bytes() as moved:
                zero_launch_counts()              # the main path starts
                row["losses"], row["step_ms"] = timed_losses(
                    torch, step, params, opt, tokens, GPT_PLAN_STEPS)
                row["launches"] = launch_counts()  # ... and ends
        row["kernel_shapes"] = shapes
        row["collective_calls_per_step"] = moved["calls"] / GPT_PLAN_STEPS
        row["collective_bytes_per_step"] = moved["bytes"] / GPT_PLAN_STEPS
        row["seconds"] = time.perf_counter() - t_s
        out[name] = row
        del step, params, opt
        torch.cuda.empty_cache()
    for ref in refs.values():
        del ref["grads"]
    return {"plans": out, "refs": refs}


def check_gpt_plans(results, card):
    """6b's GPT verdict, each plan against the unsharded step of its
    config (rank 0's gpt_reference), with 6b's gates: step 1's loss
    within 2e-3 relative, every gradient leaf's cosine >= 0.999 and its
    norm within GRAD_NORM_TOL, the trajectory within 1e-2, exactly
    gpt_step_launches a step on each rank (each rank computes the whole
    batch's attention and CE: tokens are split over neither 'ep' nor,
    outside attention, 'sp'), the flash kernels at the plan's shape
    (GPT_PLAN_ATTN; a Ulysses rank's [8, 1024, 8, 64], which phase 2b
    checked) and the CE pair at [8192, 32768]. Prints one line a plan
    with its ms a step a rank and its collective bytes a step. Returns
    {plan: [each rank's launches]}."""
    r0 = results[0]["gpt"]
    shared = results[0]["cards"] < 2
    out, failed = {}, {}
    for name in GPT_PLANS:
        rows = [res["gpt"]["plans"][name] for res in results]
        key = "moe" if "num_experts" in GPT_PLANS[name][1] else "dense"
        ref = r0["refs"][key]
        cos = rows[0]["cosine_by_leaf"]
        ratio = rows[0]["norm_ratio_by_leaf"]
        rel = [abs(a - b) / abs(b)
               for a, b in zip(rows[0]["losses"], ref["losses"])]
        want = {k: GPT_PLAN_STEPS * v for k, v in gpt_step_launches(
            gpt_plan_cfg(name), rows[0]["leaves"]).items()}
        attn = GPT_PLAN_ATTN[name]
        want_shapes = {k: None if attn is None else [list(attn[:4])]
                       for k in ("flash_fwd", "flash_bwd_dq",
                                 "flash_bwd_dkv")}
        want_shapes.update({k: [[TRAIN_BATCH * TRAIN_SEQ,
                                 FULL["vocab_size"]]]
                            for k in ("ce_fwd", "ce_bwd")})
        line = {
            "phase": "gpt_sharded_2rank", "card": card, "plan": name,
            "axes": rows[0]["axes"], "layers": SHARDED_LAYERS,
            "config": GPT_PLANS[name][1],
            "backend": results[0]["backend"], "route": results[0]["route"],
            "shared_card": shared,
            "step1_loss": rows[0]["step1_loss"],
            "step1_loss_unsharded": ref["step1_loss"],
            "step1_loss_rel_diff": abs(rows[0]["step1_loss"]
                                       - ref["step1_loss"])
            / abs(ref["step1_loss"]),
            "min_cosine": min(cos.values()), "cosine_by_leaf": cos,
            "max_norm_ratio_dev": max(abs(r - 1) for r in ratio.values()),
            "losses": rows[0]["losses"], "losses_unsharded": ref["losses"],
            "rel_diff": rel, "max_rel_diff": max(rel),
            "launches_by_rank": [r["launches"] for r in rows],
            "launches_per_step_unsharded": ref["per_step"],
            "kernel_shapes_by_rank": [r["kernel_shapes"] for r in rows],
            "step_ms_by_rank": [r["step_ms"] for r in rows],
            "step_ms_p50_by_rank": [statistics.median(r["step_ms"])
                                    for r in rows],
            "step_ms_p50_unsharded": statistics.median(ref["step_ms"]),
            "collective_calls_per_step_by_rank":
                [r["collective_calls_per_step"] for r in rows],
            "collective_bytes_per_step_by_rank":
                [r["collective_bytes_per_step"] for r in rows],
            "seconds_by_rank": [r["seconds"] for r in rows],
            "unsharded_seconds": ref["seconds"],
            "timing": ("both ranks on one card over gloo: the step times "
                       "show the host link, not scaling" if shared else
                       "one card a rank")}
        log(json.dumps(line))
        bad = []
        if not line["step1_loss_rel_diff"] <= 2e-3:
            bad.append("step-1 loss")
        if not line["min_cosine"] >= 0.999:
            worst = sorted(cos.items(), key=lambda kv: kv[1])[:3]
            bad.append(f"cosine {worst}")
        if not line["max_norm_ratio_dev"] <= GRAD_NORM_TOL:
            bad.append(f"gradient norm ratio {ratio}")
        if not line["max_rel_diff"] <= 1e-2:
            bad.append("trajectory")
        if any({k: r["launches"].get(k, 0) for k in want} != want
               or any(v for k, v in r["launches"].items() if k not in want)
               for r in rows):
            bad.append(f"launches, want {want}")
        if any({k: r["kernel_shapes"].get(k) for k in want_shapes}
               != want_shapes for r in rows) or (
                attn is not None and tuple(attn) not in ATTN_SHAPES):
            bad.append(f"kernel shapes, want {want_shapes}")
        shards = {k: list(v) for k, v in gpt_plan_shapes(name).items()}
        if any(r["shard_shapes"] != shards for r in rows):
            bad.append(f"shard shapes, want {shards} (gpt_plan_shapes, "
                       "which phase 2e's update check ran at)")
        if bad:
            failed[name] = bad
        out[name] = [r["launches"] for r in rows]
    if failed:
        raise AssertionError(f"6b GPT plans: {failed}")
    return out


def _sharded_rank(rank, world, workdir, backend):
    """One rank of phase 6b, in its own process: joins the 2-rank group
    through a file store, draws the Llama state at SHARDED_LAYERS (seed
    0) on the host, rank 0 runs the unsharded step from it
    (unsharded_reference: step 1's gradients, then 5 steps), and for
    each of SHARDED_PLANS runs step 1's loss and gradients (rank 0
    gathers them whole and takes each leaf's cosine and norm ratio
    against the unsharded step 1), then 5 steps with the launches
    counted, the kernels' shapes recorded and the peak read. Writes its
    results, with the seconds each part took, to
    workdir/rank<rank>.json."""
    bind_to_script()
    import torch
    import torch.distributed as dist
    t0 = time.perf_counter()
    cards = torch.cuda.device_count()
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank % cards))
    sys.path.insert(0, HERE)
    from paddle_tpu_torch.device import resolve_device
    from paddle_tpu_torch.models import llama
    from paddle_tpu_torch.models.facade import make_train_step
    from paddle_tpu_torch.parallel import (collective_route,
                                           init_parallel_env, plan_train)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = resolve_device(None)
    torch.cuda.set_device(dev)
    init_parallel_env(backend=backend, init_method=f"file://{workdir}/store",
                      timeout_s=900)
    try:
        cfg = llama.LlamaConfig(**dict(LLAMA, num_layers=SHARDED_LAYERS),
                                remat=True)
        host = llama.init_llama_params(cfg, seed=0, device="cpu")
        tokens = train_tokens(torch, dev, cfg, LLAMA_BATCH, LLAMA_SEQ, 3)
        out = {"rank": rank, "device": str(dev), "backend": backend,
               "route": collective_route(None, dev), "cards": cards,
               "seconds": {"start_and_draw": time.perf_counter() - t0}}
        if rank == 0:
            t_s = time.perf_counter()
            full = {k: v.to(dev) for k, v in host.items()}
            ref_loss, ref_grads = llama.loss_and_grads(full, tokens, cfg)
            out["ref_step1_loss"] = float(ref_loss)
            # kept on the host, pinned, so that the card holds no more
            # than the rank's own state while its peak is read
            ref_norms = {k: float(g.double().norm())
                         for k, g in ref_grads.items()}
            ref_grads = {k: torch.empty(g.shape, dtype=g.dtype,
                                        pin_memory=True).copy_(g)
                         for k, g in ref_grads.items()}
            out["ref"] = unsharded_reference(torch, llama, cfg, full, tokens)
            del full
            torch.cuda.empty_cache()
            out["seconds"]["unsharded_step1"] = time.perf_counter() - t_s
        from paddle_tpu_torch.parallel.checkpoint import CheckpointManager
        # 6c (b)'s snapshot, in the phase's temporary directory
        mgr = CheckpointManager(os.path.join(workdir, "ckpt_6c"),
                                max_to_keep=1)
        dist.barrier()
        for name, axes in SHARDED_PLANS.items():
            t_s = time.perf_counter()
            plan = plan_train(cfg, world, LLAMA_BATCH, **axes)
            if plan.name != name:
                raise AssertionError(f"plan {plan.name} for {name}")
            step = make_train_step(llama.train_step, cfg=cfg,
                                   mesh=plan.build_mesh(), plan=plan,
                                   **ADAMW)
            params, opt, _ = step.shard_args(
                host, lazy_opt_state(torch, host), tokens)
            hd = cfg.head_dim
            mesh = step.mesh
            row = {"plan": plan.name,
                   "q_heads": params["q_w"].shape[-1] // hd,
                   "kv_heads": params["k_w"].shape[-1] // hd,
                   "shard_shapes": {k: list(v.shape)
                                    for k, v in params.items()},
                   "state_bytes": state_bytes(params, opt)}
            secs = {"shard_args": time.perf_counter() - t_s}
            t_s = time.perf_counter()
            with forced_registry(fused_update="pallas"):
                loss1, grads = step.loss_and_grads(params, tokens)
                full = step.gather_full(grads)
                del grads
                row["step1_loss"] = float(loss1)
                if rank == 0:
                    row["cosine_by_leaf"] = {
                        k: _cos(full[k], ref_grads[k].to(dev)) for k in full}
                    row["norm_ratio_by_leaf"] = {
                        k: float(full[k].double().norm()) / ref_norms[k]
                        for k in full}
                del full
                torch.cuda.empty_cache()
                secs["step1_and_compare"] = time.perf_counter() - t_s
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t_s = time.perf_counter()
                with kernel_shapes() as shapes:
                    zero_launch_counts()          # the main path starts
                    if name == CKPT_SAVE_PLAN:
                        # 6c (b): a synchronous save after step 2, out of
                        # the timed steps (it launches no kernel)
                        row["losses"], row["step_ms"] = timed_losses(
                            torch, step, params, opt, tokens, 2)
                        row["checkpoint"] = rank_save(
                            torch, step, params, opt, mgr, 2)
                        more = timed_losses(torch, step, params, opt,
                                            tokens, 3)
                        row["losses"] += more[0]
                        row["step_ms"] += more[1]
                    else:
                        row["losses"], row["step_ms"] = timed_losses(
                            torch, step, params, opt, tokens, 5)
                    row["launches"] = launch_counts()  # ... and ends
                row["kernel_shapes"] = shapes
                secs["five_steps"] = time.perf_counter() - t_s
                row["max_memory_allocated_bytes"] = \
                    torch.cuda.max_memory_allocated()
                if plan.pp > 1:
                    t_s = time.perf_counter()
                    row["bubble_fraction"] = step.bubble_fraction
                    row["handoff_route"] = collective_route(
                        mesh.get_group("pp"), dev)
                    row["handoff_profile"] = handoff_profile(
                        torch, step, params, opt, tokens)
                    secs["handoff_profile"] = time.perf_counter() - t_s
                if name == CKPT_LOAD_PLAN:
                    del params, opt
                    torch.cuda.empty_cache()
                    t_s = time.perf_counter()
                    row["resumed"] = rank_resume(torch, step, plan, mgr,
                                                 tokens, host)
                    secs["restore_and_resume"] = time.perf_counter() - t_s
                    params = opt = None
            row["seconds"] = secs
            out[plan.name] = row
            del step, params, opt
            torch.cuda.empty_cache()
        del host
        t_s = time.perf_counter()
        out["gpt"] = gpt_sharded_plans(torch, rank, dev)
        out["seconds"]["gpt_plans"] = time.perf_counter() - t_s
        with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


def check_two_ranks(results, card):
    """Phase 6b's verdict from both ranks' results, against the unsharded
    step at the same depth from the same state on rank 0 (`ref`,
    unsharded_reference): per plan, step 1's loss within 2e-3 relative
    of the unsharded step 1's and every gradient leaf's cosine >= 0.999
    against it (phase 4's tolerances), its norm within GRAD_NORM_TOL of
    the unsharded one's, the 5-step trajectory within 1e-2 of the
    unsharded one's, exactly the launches a step its plan gives on each
    rank (sharded_launches: the unsharded step's under a 3D plan), each
    rank's heads and shard shapes, the shapes its kernels launched at
    (those phase 2 checked; none of the CE's under pp), and each rank's
    params and moments exactly the bytes of its shards
    (shard_state_bytes), at most 51% of the unsharded state's under a
    3D plan. A pp plan also prints its handoff route, its handoffs'
    times and the share of a step each rank spends in them (the
    measured idle share), and the step's bubble (its 1F1B timeline's,
    fixed by (pp, m)) must equal (pp-1)/(m+pp-1) and lie within 1.5x
    of the planner's (pp-1)/m. Prints one line a plan. Returns {plan:
    [each rank's launches]}."""
    r0 = results[0]
    ref = r0["ref"]
    shared = r0["cards"] < 2
    ref1 = ref["losses"][0]
    out, failed = {}, {}
    for name, (q_heads, kv_heads) in SHARDED_HEADS.items():
        rows = [res[name] for res in results]
        cos = rows[0]["cosine_by_leaf"]
        ratio = rows[0]["norm_ratio_by_leaf"]
        B, S, H, D, _ = SHARDED_ATTN[name]
        want_shapes = {k: [[B, S, H, D]] for k in
                       ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
        want_shapes.update({k: [list(SHARDED_CE[name])] if name in
                            SHARDED_CE else None for k in ("ce_fwd",
                                                           "ce_bwd")})
        rel = [abs(a - b) / abs(b)
               for a, b in zip(rows[0]["losses"], ref["losses"])]
        want = {k: 5 * v for k, v in
                sharded_launches(name, ref["per_step"]).items()}
        line = {
            "phase": "llama_sharded_2rank", "card": card, "plan": name,
            "layers": SHARDED_LAYERS,
            "backend": r0["backend"], "route": r0["route"],
            "cards": r0["cards"], "devices": [res["device"]
                                             for res in results],
            "shared_card": shared,
            "step1_loss": rows[0]["step1_loss"],
            "step1_loss_unsharded": ref1,
            "step1_loss_rel_diff": abs(rows[0]["step1_loss"] - ref1)
            / abs(ref1),
            "unsharded_grads_step1_loss": r0["ref_step1_loss"],
            "min_cosine": min(cos.values()), "cosine_by_leaf": cos,
            "max_norm_ratio_dev": max(abs(r - 1) for r in ratio.values()),
            "norm_ratio_by_leaf": ratio,
            "losses": rows[0]["losses"], "losses_unsharded": ref["losses"],
            "rel_diff": rel, "max_rel_diff": max(rel),
            "launches_by_rank": [r["launches"] for r in rows],
            "launches_per_step_unsharded": ref["per_step"],
            "heads_by_rank": [[r["q_heads"], r["kv_heads"]] for r in rows],
            "kernel_shapes_by_rank": [r["kernel_shapes"] for r in rows],
            "shard_shapes": rows[0]["shard_shapes"],
            "state_bytes_by_rank": [r["state_bytes"] for r in rows],
            "state_bytes_unsharded": ref["state_bytes"],
            "max_memory_allocated_bytes_by_rank":
                [r["max_memory_allocated_bytes"] for r in rows],
            "max_memory_allocated_bytes_unsharded": ref["peak"],
            "step_ms_by_rank": [r["step_ms"] for r in rows],
            "step_ms_p50_by_rank": [statistics.median(r["step_ms"][1:])
                                    for r in rows],
            "step_ms_p50_unsharded": ref["step_ms_p50"],
            "seconds_by_rank": [dict(res["seconds"], **r["seconds"])
                                for res, r in zip(results, rows)],
            "timing": ("both ranks on one card over gloo: shared-card "
                       "times, no scaling" if shared else
                       "one card a rank")}
        pp = plan_pp(name)
        if pp > 1:
            m = SHARDED_PLANS[name]["microbatches"]
            line.update({
                "microbatches": m,
                "handoff_route_by_rank": [r["handoff_route"] for r in rows],
                "bubble_fraction_by_rank":
                    [r["bubble_fraction"] for r in rows],
                "bubble_schedule": (pp - 1) / (m + pp - 1),
                "bubble_planner": (pp - 1) / m,
                "handoff_profile_by_rank":
                    [r["handoff_profile"] for r in rows],
                "handoff_share_by_rank":
                    [r["handoff_profile"]["handoff_share"] for r in rows],
                "state_share_of_unsharded": [
                    r["state_bytes"] / ref["state_bytes"] for r in rows]})
        log(json.dumps(line))
        bad = []
        if not line["step1_loss_rel_diff"] <= 2e-3:
            bad.append("step-1 loss")
        if not line["min_cosine"] >= 0.999:
            bad.append(f"cosine {sorted(cos.items(), key=lambda kv: kv[1])[:3]}")
        if not line["max_norm_ratio_dev"] <= GRAD_NORM_TOL:
            bad.append(f"gradient norm ratio {ratio}")
        if not line["max_rel_diff"] <= 1e-2:
            bad.append("trajectory")
        if any(r["launches"] != want for r in rows):
            bad.append(f"launches, want {want}")
        if any((r["q_heads"], r["kv_heads"]) != (q_heads, kv_heads)
               for r in rows):
            bad.append("heads")
        if any(r["state_bytes"] != shard_state_bytes(name) for r in rows) \
                or (pp == 1 and any(r["state_bytes"] > 0.51 * ref[
                    "state_bytes"] for r in rows)):
            bad.append(f"state bytes, want {shard_state_bytes(name)}")
        if pp > 1 and any(
                r["bubble_fraction"] != line["bubble_schedule"]
                or not max(r["bubble_fraction"], line["bubble_planner"])
                <= 1.5 * min(r["bubble_fraction"], line["bubble_planner"])
                for r in rows):
            bad.append("bubble")
        local = {k: list(v) for k, v in shard_shapes(name).items()}
        if any(r["shard_shapes"] != local for r in rows):
            bad.append(f"shard shapes, want {local}")
        # the kernels ran at the local shapes that phase 2 checked
        if any({k: r["kernel_shapes"].get(k) for k in want_shapes}
               != want_shapes for r in rows) or \
                tuple(SHARDED_ATTN[name]) not in ATTN_SHAPES or \
                (name in SHARDED_CE
                 and tuple(SHARDED_CE[name]) not in CE_PAIR_SHAPES):
            bad.append(f"kernel shapes, want {want_shapes}")
        if bad:
            failed[name] = bad
        out[name] = [r["launches"] for r in rows]
    if failed:
        raise AssertionError(f"6b: {failed}")
    return out


def check_resume(results, card):
    """6c (b)'s verdict: both ranks wrote their halves of one snapshot of
    the fsdp2 state after its step 2; restored onto pp2 (each rank a
    stage's half of the stacked leaves, shard_shapes), the restored
    state's marginals equal the saved state's (MARGINAL_RTOL: every
    params, m and v value in its place), its RESUME_STEPS losses lie
    within RESUME_TOL of fsdp2's own steps 3-5, and every rank reports
    the same global losses. Prints one line."""
    saves = [res[CKPT_SAVE_PLAN]["checkpoint"] for res in results]
    resumed = [res[CKPT_LOAD_PLAN]["resumed"] for res in results]
    want = results[0][CKPT_SAVE_PLAN]["losses"][2:2 + RESUME_STEPS]
    got = resumed[0]["losses"]
    rel = [abs(a - b) / abs(b) for a, b in zip(got, want)]
    total = saves[0]["checkpoint_bytes"]
    saved = summed_marginals(c.pop("marginals") for c in saves)
    restored = summed_marginals(r.pop("marginals") for r in resumed)
    off, worst = [], 0.0
    for key in sorted(set(saved) | set(restored)):
        a, b = saved.get(key), restored.get(key)
        if a is None or b is None or [len(x) for x in a] != \
                [len(x) for x in b]:
            off.append(key)
            continue
        for d, (x, y) in enumerate(zip(a, b)):
            diff = np.abs(y - x)
            worst = max(worst, float(np.max(diff / np.maximum(
                x, np.finfo(np.float64).tiny))))
            if not np.all(diff <= MARGINAL_RTOL * x):
                off.append(f"{key} dim {d}")
    line = {
        "phase": "llama_ckpt_fsdp2_to_pp2", "card": card,
        "saved_plan": CKPT_SAVE_PLAN, "restored_plan": CKPT_LOAD_PLAN,
        "checkpoint_bytes": total,
        "bytes_written_by_rank": [c["bytes_written"] for c in saves],
        "save_s_by_rank": [c["save_s"] for c in saves],
        "save_gb_per_s": total / max(c["save_s"] for c in saves) / 1e9,
        "free_disk_before_after": [saves[0]["free_before"],
                                   saves[0]["free_after"]],
        "restore_s_by_rank": [r["restore_s"] for r in resumed],
        "restored_step_by_rank": [r["restored_step"] for r in resumed],
        "restored_opt_step_by_rank": [r["opt_step"] for r in resumed],
        "marginals_checked": sum(len(x) for x in saved.values()),
        "marginals_max_rel_diff": worst, "marginals_off": off,
        "losses_by_rank": [r["losses"] for r in resumed],
        "saved_plan_steps_3_5": want, "rel_diff": rel,
        "max_rel_diff": max(rel),
        "step_ms_by_rank": [r["step_ms"] for r in resumed]}
    log(json.dumps(line))
    bad = []
    if sum(line["bytes_written_by_rank"]) != total:
        bad.append("bytes written")
    if line["restored_step_by_rank"] != [2] * len(resumed) or \
            line["restored_opt_step_by_rank"] != [2.0] * len(resumed):
        bad.append("restored step")
    if off or not saved:
        bad.append("restored values")
    if any(r["losses"] != got for r in resumed):
        bad.append("ranks' losses differ")
    if not all(math.isfinite(x) for x in got) or max(rel) > RESUME_TOL:
        bad.append("trajectory")
    local = {k: list(v) for k, v in shard_shapes(CKPT_LOAD_PLAN).items()}
    if any(r["shard_shapes"] != local for r in resumed):
        bad.append(f"restored shard shapes, want {local}")
    if bad:
        raise AssertionError(f"6c (b): {bad}: {line}")
    return line


def sharded_two_ranks(torch, card):
    """Phase 6b: the plans of SHARDED_PLANS on two spawned ranks at 6a's
    widths and global batch, SHARDED_LAYERS deep: one card a rank over
    NCCL with two or more cards; on one card both ranks share it over
    gloo, through parallel/collective.py's all-reduce route for CUDA
    tensors. A failure in a rank is this phase's failure. Returns
    {plan: [each rank's launches over its 5 steps]}."""
    import tempfile
    import torch.multiprocessing as mp
    backend = "nccl" if torch.cuda.device_count() >= 2 else "gloo"
    workdir = tempfile.mkdtemp(prefix="chip_smoke_6b_")
    try:
        mp.spawn(_sharded_rank, args=(2, workdir, backend), nprocs=2,
                 join=True)
        results = []
        for r in range(2):
            with open(os.path.join(workdir, f"rank{r}.json")) as f:
                results.append(json.load(f))
    finally:
        import shutil
        shutil.rmtree(workdir, ignore_errors=True)
    out = check_two_ranks(results, card)
    check_resume(results, card)
    return out, check_gpt_plans(results, card)


# phase 6c (a): the full-depth state saved asynchronously and resumed;
# the drill: the resilient step at DRILL_LAYERS layers
# the resilience drill's and 6d's depth
DRILL_LAYERS = 2
DRILL_STEPS, DRILL_FAULT = 6, "nan@3:3"


def guard_cost(torch, params, opt):
    """What the resilient step's guard adds to a step on this state, on
    the card: the pre-step copy of params and moments into kept buffers
    (parallel/resilience.py `_Backup`, warm) and the finiteness check of
    both trees with its host read, each timed with CUDA events over 3
    runs; bytes: the copy reads and writes the state, the check reads
    it."""
    from paddle_tpu_torch.parallel.resilience import _Backup, _tree_finite
    backup = _Backup()
    backup.save(params, opt)
    nbytes = backup.nbytes

    def copy():
        backup.save(params, opt)

    def check():
        bool(_tree_finite(params) & _tree_finite(opt))
    out = {"state_bytes": nbytes, "copy_ms": event_ms(torch, copy, 3),
           "copy_bytes": 2 * nbytes, "check_ms": event_ms(torch, check, 3),
           "check_bytes": nbytes}
    out["copy_bound_ms"] = 2 * nbytes / PEAK_BYTES * 1e3
    out["check_bound_ms"] = nbytes / PEAK_BYTES * 1e3
    # the check on the card sees one planted inf, -inf or nan in the
    # largest leaf
    leaf = max(params.values(), key=lambda t: t.numel()).view(-1)
    keep = leaf[leaf.numel() // 2].clone()
    out["check_catches"] = {}
    for name, bad in (("inf", float("inf")), ("-inf", float("-inf")),
                      ("nan", float("nan"))):
        leaf[leaf.numel() // 2] = bad
        out["check_catches"][name] = not bool(_tree_finite(params))
        leaf[leaf.numel() // 2] = keep
    out["check_clean"] = bool(_tree_finite(params) & _tree_finite(opt))
    if not (all(out["check_catches"].values()) and out["check_clean"]):
        raise AssertionError(f"the guard's finiteness check: {out}")
    del backup
    torch.cuda.empty_cache()
    return out


def checkpoint_resume(torch, dev, card, p4):
    """Phase 6c (a): phase 4's configuration and starting state (seed 0,
    tokens seed 3, full remat, the fused update forced, the two-pass
    CE), one rank, full depth: 2 steps; CheckpointManager.save_async of
    the 12.4 GB state (pinned host buffers filled by copies queued on the
    stream), step 3 while the writer runs, steps 4 and 5; wait(),
    verify_checkpoint; the snapshot loaded into fresh buffers on the
    card with template=, and steps 3-5 again from it, whose losses must
    equal the uninterrupted steps 3-5 to the bit. A second snapshot
    into the kept buffers times the step path's cost without the first
    allocation; the guard's copy and check are timed on this state.
    Prints the bytes, save_async's host ms and the copies' device ms,
    the writer's seconds and GB/s, verify and restore seconds, and the
    free disk before and after. The snapshot is deleted in a finally.
    The monitor must count the save (the async writer's), the snapshot,
    the verify and the load (the restore into fresh buffers), and the
    span log hold their spans (CKPT_COUNTERS, CKPT_SPANS). Returns the
    train kernels' launches over its 8 steps."""
    import shutil
    import tempfile
    from paddle_tpu_torch.models import llama
    from paddle_tpu_torch.models.facade import make_train_step
    from paddle_tpu_torch.models.gpt import init_opt_state
    from paddle_tpu_torch.parallel import checkpoint as ck
    from paddle_tpu_torch.profiler import (clear_profiler_spans,
                                           get_profiler_spans, monitor)
    counted = {n: monitor.counter(n).value for n in CKPT_COUNTERS}
    clear_profiler_spans()
    cfg = llama.LlamaConfig(**LLAMA, remat=True)
    params = {k: v.to(dev) for k, v in llama_full_host().items()}
    _LLAMA_HOST.clear()                          # its last reader
    opt = init_opt_state(params)
    tokens = train_tokens(torch, dev, cfg, LLAMA_BATCH, LLAMA_SEQ, 3)
    nbytes = state_bytes(params, opt)
    step = make_train_step(llama.train_step, cfg=cfg, **ADAMW)
    root = tempfile.mkdtemp(prefix="chip_smoke_6c_")
    line = {"phase": "llama_checkpoint_resume", "card": card,
            "state_bytes": nbytes}
    try:
        line["free_disk_before"] = disk_check(root, nbytes,
                                              "llama_checkpoint_resume")
        mgr = ck.CheckpointManager(root, max_to_keep=1)
        with forced_registry(fused_update="pallas"):
            zero_launch_counts()                  # the main path starts
            losses = [float(step(params, opt, tokens)[0]) for _ in range(2)]
            state = {"params": params, "opt_state": opt,
                     "step": np.int64(2)}
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            torch.cuda.synchronize()
            t_s = time.perf_counter()
            ev[0].record()
            path = mgr.save_async(state, 2)
            ev[1].record()
            line["save_async_host_ms"] = (time.perf_counter() - t_s) * 1e3
            line["snapshot_bytes"] = mgr.last_snapshot_bytes
            # step 3 while the writer runs: it updates the same tensors
            losses.append(float(step(params, opt, tokens)[0]))
            line["writer_pending_after_step3"] = mgr.async_pending
            line["snapshot_copies_ms"] = ev[0].elapsed_time(ev[1])
            losses += [float(step(params, opt, tokens)[0])
                       for _ in range(2)]
            t_s = time.perf_counter()
            mgr.wait()
            line["wait_after_step5_s"] = time.perf_counter() - t_s
            line["write_s"] = mgr.last_write_s
            line["write_gb_per_s"] = nbytes / mgr.last_write_s / 1e9
            line["free_disk_written"] = shutil.disk_usage(root).free
            t_s = time.perf_counter()
            ck.verify_checkpoint(path)
            line["verify_s"] = time.perf_counter() - t_s
            # the step path's cost once the pinned buffers exist
            torch.cuda.synchronize()
            t_s = time.perf_counter()
            ev[0].record()
            again = ck.HostSnapshot(state, pool=mgr._pool)
            ev[1].record()
            line["snapshot_reuse_host_ms"] = (time.perf_counter() - t_s) * 1e3
            again.wait()
            line["snapshot_reuse_copies_ms"] = ev[0].elapsed_time(ev[1])
            line["snapshot_reuse_alloc_bytes"] = again.alloc_bytes
            del again
            line["guard"] = guard_cost(torch, params, opt)
            template = {"params": params, "opt_state": opt, "step": None}
            torch.cuda.synchronize()
            t_s = time.perf_counter()
            got = ck.load_sharded(path, mesh=None, template=template,
                                  verify=False, device=dev)
            torch.cuda.synchronize()
            line["restore_s"] = time.perf_counter() - t_s
            line["restored_step"] = int(got["step"])
            line["fresh_buffers"] = all(
                got["params"][k].data_ptr() != params[k].data_ptr()
                for k in params)
            resumed = [float(step(got["params"], got["opt_state"],
                                  tokens)[0]) for _ in range(3)]
            launches = launch_counts()            # ... and ends
        del got, mgr
    finally:
        shutil.rmtree(root, ignore_errors=True)
        line["free_disk_after"] = shutil.disk_usage(
            os.path.dirname(root)).free
    del params, opt, state, tokens, step
    gc.collect()
    torch.cuda.empty_cache()
    per_step = p4["train"]["launches_per_step"]
    line["monitor"] = {n: monitor.counter(n).value - counted[n]
                       for n in CKPT_COUNTERS}
    line["monitor"]["checkpoint_async_pending"] = monitor.gauge(
        "checkpoint_async_pending").value
    spans = {}
    for name, _start, dur, *_ in get_profiler_spans():
        if name in CKPT_SPANS:
            spans.setdefault(name, []).append(dur)
    line["spans_s"] = spans
    line.update({"losses": losses, "resumed_steps_3_5": resumed,
                 "phase4_losses": p4["trajectory"],
                 "equal_to_phase4": losses == p4["trajectory"],
                 "resumed_bitwise_equal": resumed == losses[2:],
                 "launches": launches})
    log(json.dumps(line))
    if resumed != losses[2:] or line["restored_step"] != 2 or \
            not line["fresh_buffers"]:
        raise AssertionError(f"6c (a): resumed {resumed} != uninterrupted "
                             f"{losses[2:]} (or step/buffers): {line}")
    if launches != {k: 8 * v for k, v in per_step.items()}:
        raise AssertionError(f"6c (a): launches {launches} over 8 steps, "
                             f"phase 4 {per_step} a step")
    if line["monitor"] != dict(CKPT_COUNTERS, checkpoint_async_pending=0) \
            or sorted(spans) != sorted(CKPT_SPANS):
        raise AssertionError(f"6c (a): counters {line['monitor']} (want "
                             f"{CKPT_COUNTERS}), spans {sorted(spans)}")
    return launches


# what 6c (a) runs, counted by the checkpoint module's monitor stats and
# spans: one save_async (its writer's save), one verify, one load
CKPT_COUNTERS = {"checkpoint_save": 1, "checkpoint_async_save": 1,
                 "checkpoint_verify": 1, "checkpoint_load": 1,
                 "checkpoint_async_retry": 0}
CKPT_SPANS = ("checkpoint.save", "checkpoint.snapshot", "checkpoint.verify",
              "checkpoint.load")


def drill_tokens(torch, dev, cfg, s):
    return train_tokens(torch, dev, cfg, LLAMA_BATCH, LLAMA_SEQ, 100 + s)


def resilience_drill(torch, dev, card):
    """The resilient step drill (parallel/resilience.py): one rank,
    TinyLlama widths at DRILL_LAYERS layers, batch 4 x 2048, full remat,
    the fused update forced, a batch a step (seed 100 + step). A clean
    ResilientTrainer (CheckpointManager(max_to_keep=2), checkpoint_every
    2, rollback_after 3, a 120 s watchdog, so every step runs on the
    watchdog's thread) runs DRILL_STEPS steps; another from the same
    state under DRILL_FAULT: three skips, each leaving every param and
    moment equal to its pre-step value to the bit, then a rollback to
    the step-2 snapshot and on to step 6, its re-run losses and final
    state equal to the clean run's to the bit. Then a 2 s stall inside
    the step under a 0.5 s budget with 0 retries must raise
    StepHungError (the stalled step is waited out before the phase
    ends). The faulted run carries the device telemetry
    (RESILIENT_FIELDS, a flush every DRILL_TELE_EVERY steps): its stream
    must read ok 0 on exactly the three skipped steps, the monitor 3
    skips, 1 rollback and 1 watchdog hang, and the 'rollback' and
    'watchdog_hang' flight dumps must load. The guard's copy and check
    are timed on this state. Returns the train kernels' launches over
    the two runs' steps."""
    import shutil
    import tempfile
    from paddle_tpu_torch.models import llama
    from paddle_tpu_torch.models.gpt import init_opt_state
    from paddle_tpu_torch.parallel import resilience
    from paddle_tpu_torch.parallel.checkpoint import CheckpointManager
    from paddle_tpu_torch.profiler import flight_recorder, monitor, telemetry
    from paddle_tpu_torch.testing import faults
    cfg = llama.LlamaConfig(**dict(LLAMA, num_layers=DRILL_LAYERS),
                            remat=True)
    L = cfg.num_layers
    init = llama.init_llama_params(cfg, seed=0)
    root = tempfile.mkdtemp(prefix="chip_smoke_drill_")

    def trainer(name, tele=None, **cfg_kw):
        params = {k: v.clone() for k, v in init.items()}
        return resilience.ResilientTrainer(
            llama.train_step, params, init_opt_state(params), cfg=cfg,
            manager=CheckpointManager(os.path.join(root, name),
                                      max_to_keep=2), telemetry=tele,
            config=resilience.ResilienceConfig(
                checkpoint_every=2, rollback_after=3, watchdog_timeout=120.0,
                retries=0, **cfg_kw), **ADAMW)

    def state(tr):
        return {"p": tr.params, "m": tr.opt_state["m"],
                "v": tr.opt_state["v"], "step": tr.opt_state["step"]}

    def same(a, b):
        return all(torch.equal(a[k], b[k]) if isinstance(a[k], torch.Tensor)
                   else same(a[k], b[k]) for k in a)

    def clone(tree):
        return {k: v.clone() if isinstance(v, torch.Tensor) else clone(v)
                for k, v in tree.items()}
    line = {"phase": "llama_resilience_drill", "card": card, "layers": L,
            "fault": DRILL_FAULT}
    rec = flight_recorder.recorder()
    saved_rec = (rec.dir, rec.autodump_every)
    rec.set_dir(os.path.join(root, "flight"))
    rec.autodump_every = 0
    counted = {n: monitor.counter(n).value for n in DRILL_COUNTERS}
    tele = telemetry.TelemetryPipeline(
        os.path.join(root, "drill.jsonl"), every=DRILL_TELE_EVERY,
        fields=resilience.RESILIENT_FIELDS)
    try:
        # at most 2 kept snapshots and 1 being staged at a time
        nbytes = 3 * 4 * sum(p.numel() for p in init.values())
        line["free_disk_before"] = disk_check(root, 3 * nbytes,
                                              "llama_resilience_drill")
        with forced_registry(fused_update="pallas"):
            zero_launch_counts()                  # the main path starts
            t_s = time.perf_counter()
            clean = trainer("clean")
            traj = {}
            resilience.run_resilient(
                clean, lambda s: drill_tokens(torch, dev, cfg, s),
                DRILL_STEPS, on_step=lambda s, loss, ok: traj.setdefault(
                    s, []).append((loss, ok)))
            line["clean_s"] = time.perf_counter() - t_s
            clean_state = clone(state(clean))
            shutil.rmtree(clean.manager.root, ignore_errors=True)
            del clean
            t_s = time.perf_counter()
            tr = trainer("fault", tele)
            fault_traj, skip_equal, box = {}, [], {}
            rollback = tr._rollback

            def checked_rollback():
                # the skip that ends the streak, before the state rewinds
                skip_equal.append(same(box["before"], state(tr)))
                rollback()
            tr._rollback = checked_rollback
            faults.install(DRILL_FAULT, once_dir=None)
            try:
                while tr.step < DRILL_STEPS:
                    s, rolled = tr.step, tr.rollbacks
                    box["before"] = clone(state(tr))
                    loss, ok = tr.train_step(drill_tokens(torch, dev, cfg,
                                                          s))
                    fault_traj.setdefault(s, []).append((loss, ok))
                    if not ok and tr.rollbacks == rolled:
                        skip_equal.append(same(box["before"], state(tr)))
                    box.clear()
            finally:
                faults.uninstall()
                tr._rollback = rollback
            line["fault_s"] = time.perf_counter() - t_s
            launches = launch_counts()            # ... and ends
            executed = sum(len(v) for v in traj.values()) + sum(
                len(v) for v in fault_traj.values())
            line.update({
                "clean": traj, "faulted": fault_traj,
                "skipped": tr.skipped, "rollbacks": tr.rollbacks,
                "step": tr.step, "skips_bit_equal": skip_equal,
                "rerun_equal_clean": all(fault_traj[s][-1] == traj[s][-1]
                                         for s in traj),
                "final_equal_clean": same(clean_state, state(tr)),
                "snapshots": tr.manager.steps(),
                "steps_executed": executed, "launches": launches,
                "guard": guard_cost(torch, tr.params, tr.opt_state)})
            del clean_state
            # a 2 s stall inside the step under a 0.5 s budget
            tr.config.watchdog_timeout, tr.config.retries = 0.5, 0
            tr.manager = None
            stalled = tr._puller._res
            resilience._STEP_HOOK = lambda step: (time.sleep(2.0), 1.0)[1]
            t_s = time.perf_counter()
            try:
                tr.train_step(drill_tokens(torch, dev, cfg, tr.step))
                line["stall"] = "no StepHungError"
            except resilience.StepHungError as e:
                line["stall"] = f"StepHungError after " \
                    f"{time.perf_counter() - t_s:.3f} s: {e}"
            finally:
                resilience._STEP_HOOK = None
            # the stalled step runs on after its budget: wait it out
            stalled.get(timeout=120)
            torch.cuda.synchronize()
            tele.close(tr._tstate)
            line["telemetry"] = [
                r for r in map(json.loads, open(os.path.join(
                    root, "drill.jsonl"))) if r["kind"] == "step"]
            line["telemetry_pulls"] = tele.pulls
            line["monitor"] = {n: monitor.counter(n).value - counted[n]
                               for n in DRILL_COUNTERS}
            dumps = {}
            for reason in ("rollback", "watchdog_hang"):
                doc = flight_recorder.load_dump(os.path.join(
                    root, "flight", f"flight-{os.getpid()}-{reason}.json"))
                dumps[reason] = {"steps": len(doc["steps"]),
                                 "config": sorted(doc["config"])}
            line["dumps"] = dumps
    finally:
        rec.clear()
        rec.set_dir(saved_rec[0])
        rec.autodump_every = saved_rec[1]
        shutil.rmtree(root, ignore_errors=True)
    del tr, init
    gc.collect()
    torch.cuda.empty_cache()
    log(json.dumps(line))
    per_step = {"flash_fwd": 2 * L, "flash_bwd_dq": L, "flash_bwd_dkv": L,
                "ce_fwd": 1, "ce_bwd": 1, "leaf_update": 1,
                "leaf_update_leaves": 11}
    bad = []
    if (line["skipped"], line["rollbacks"], line["step"]) != (3, 1,
                                                              DRILL_STEPS):
        bad.append("skips/rollbacks/step")
    if skip_equal != [True] * 3:
        bad.append("a skipped step changed the state")
    if [s for s in sorted(fault_traj) if len(fault_traj[s]) > 1] != \
            [2, 3, 4, 5] or not line["rerun_equal_clean"] or \
            not line["final_equal_clean"]:
        bad.append("the re-run after the rollback is not the clean run's")
    if not all(ok and math.isfinite(loss) for v in traj.values()
               for loss, ok in v):
        bad.append("the clean run skipped")
    if not line["stall"].startswith("StepHungError"):
        bad.append("stall")
    if launches != {k: executed * per_step.get(k, 0) for k in launches}:
        bad.append(f"launches, want {executed} x {per_step}")
    rows = line["telemetry"]
    # the faulted run's steps in order (the rollback writes the rows
    # since the last flush and restarts the ids at step 2), then the
    # stalled step, which ran on after its budget
    if [r["step"] for r in rows] != [0, 1, 2, 3, 4, 5, 2, 3, 4, 5, 6] or \
            [r["ok"] for r in rows].count(0.0) != 3 or \
            [r["step"] for r in rows if r["ok"] == 0.0] != [3, 4, 5] or \
            any(r["nonfinite"] != 0 for r in rows):
        bad.append("telemetry rows")
    if line["monitor"] != DRILL_COUNTERS:
        bad.append(f"counters {line['monitor']}, want {DRILL_COUNTERS}")
    if bad:
        raise AssertionError(f"drill: {bad}")
    return launches


# the drill's device telemetry cadence, and what its monitor must count
# over the faulted run and the stall
DRILL_TELE_EVERY = 4
DRILL_COUNTERS = {"resilience_skip_step": 3, "resilience_rollback": 1,
                  "resilience_watchdog_hang": 1, "checkpoint_restore": 1}


# phase 6d: the elastic drill at DRILL_LAYERS layers, fsdp2 on two ranks
# through the port's launcher (python -m paddle_tpu_torch.distributed.
# launch), each rank this script run as `--elastic-worker MODE DIR`; the
# loss at step ELASTIC_LOSS_AT's boundary, after the snapshot there
ELASTIC_STEPS = 3
ELASTIC_LOSS_AT = 2
ELASTIC_LOSS = f"device_loss@{ELASTIC_LOSS_AT}:1"
ELASTIC_BUDGET_S = 8.0
ELASTIC_STRAGGLER = "straggler@2:1000"
# the hang comes after the uninterrupted run's ELASTIC_STEPS steps
ELASTIC_HANG = (f"collective_hang@{ELASTIC_STEPS}:"
                f"{int((ELASTIC_BUDGET_S + 2) * 1000)}")
ELASTIC_HANG_STEPS = ELASTIC_STEPS + 1


def proc_start_time():
    """The wall time this process started (its start in clock ticks
    after boot, /proc/self/stat, plus the boot time, /proc/stat), to
    0.01 s."""
    with open("/proc/self/stat") as f:
        ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/stat") as f:
        btime = next(int(line.split()[1]) for line in f
                     if line.startswith("btime"))
    return btime + ticks / os.sysconf("SC_CLK_TCK")


def elastic_worker(mode, workdir):
    """A rank of phase 6d under the port's launcher. The Llama step at
    TinyLlama widths and DRILL_LAYERS layers, batch 4 x 2048, full
    remat, the fused update forced, the drill's batches (seed 100 +
    step), on the plan fsdp2 (ranks sharing a card over gloo):

    - mode "loss", first launch: an ElasticTrainer with restart_on_loss
      under ELASTIC_LOSS (a snapshot every ELASTIC_LOSS_AT steps) runs
      steps 0 to ELASTIC_LOSS_AT - 1; the loss at step ELASTIC_LOSS_AT's
      boundary writes the world spec {n_devices: 1} and exits 101;
    - mode "loss", relaunched (one rank, the spec granted): the trainer
      plans onto fsdp1, resumes from ckpt-ELASTIC_LOSS_AT and runs the
      steps from there to ELASTIC_STEPS (no more snapshots);
    - mode "hang": the uninterrupted run, ELASTIC_STEPS steps under the
      ELASTIC_BUDGET_S step watchdog with a straggler within it (no
      replan; a snapshot every ELASTIC_STEPS steps), then a collective
      hang past the budget at step ELASTIC_STEPS: rank 1 declared lost
      leaves (exit 103), rank 0 re-forms a world of one, restores the
      step-ELASTIC_STEPS snapshot onto fsdp1 and runs that step.

    Each rank writes its results, with the steps it ran and its kernel
    launches, to DIR/<mode>.<launch>.rank<N>.json."""
    import torch
    import torch.distributed as dist
    t_entry = time.time()
    sys.path.insert(0, HERE)
    from paddle_tpu_torch.device import resolve_device
    from paddle_tpu_torch.distributed.launch import heartbeat
    from paddle_tpu_torch.models import llama
    from paddle_tpu_torch.models.gpt import init_opt_state
    from paddle_tpu_torch.parallel import (CheckpointManager,
                                           ResilienceConfig, collective_route,
                                           init_parallel_env, plan_train)
    from paddle_tpu_torch.parallel.elastic import (ElasticConfig,
                                                   ElasticDeparture,
                                                   ElasticTrainer,
                                                   run_elastic)
    from paddle_tpu_torch.testing import faults
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = resolve_device(None)
    torch.cuda.set_device(dev)
    init_parallel_env(timeout_s=900)
    rank, world = dist.get_rank(), dist.get_world_size()
    granted = heartbeat.degraded_world()
    launch = "relaunch" if granted else "first"
    cfg = llama.LlamaConfig(**dict(LLAMA, num_layers=DRILL_LAYERS),
                            remat=True)
    out = {"mode": mode, "launch": launch, "rank": rank, "world": world,
           "granted": granted, "t_spawn": proc_start_time(),
           "t_import": T_IMPORT, "t_entry": t_entry,
           "route": collective_route(None, dev),
           "backend": str(dist.get_backend()), "steps_run": 0}

    def batch(s):
        return drill_tokens(torch, dev, cfg, s)

    def trainer(root, ecfg, every):
        params = llama.init_llama_params(cfg, seed=0, device=dev)
        return ElasticTrainer(
            llama.train_step, params, init_opt_state(params), cfg=cfg,
            global_batch=LLAMA_BATCH,
            manager=CheckpointManager(os.path.join(workdir, root),
                                      max_to_keep=0),
            plan=plan_train(cfg, 2, LLAMA_BATCH, dp=1, fsdp=2, tp=1),
            config=ecfg, resilience=ResilienceConfig(checkpoint_every=every),
            **ADAMW)

    def run(et, steps, losses, times, replans=None):
        def on_step(s, loss, ok):
            torch.cuda.synchronize()
            losses[s] = loss
            times[s] = time.time()
            out["steps_run"] += 1
            if replans is not None:
                replans[s] = et.replans
        run_elastic(et, batch, steps, on_step=on_step)

    def save():
        from paddle_tpu_torch.profiler import monitor
        out["launches"] = launch_counts()
        out["pid"] = os.getpid()
        out["flight_dir"] = os.environ.get("PADDLE_TPU_FLIGHT_DIR")
        out["elastic"] = {k: v for k, v in monitor.snapshot().items()
                          if k.startswith("train.elastic.")}
        with open(os.path.join(workdir, f"{mode}.{launch}.rank{rank}.json"),
                  "w") as f:
            json.dump(out, f)
    zero_launch_counts()
    try:
        with forced_registry(fused_update="pallas"):
            if mode == "loss" and launch == "first":
                faults.install(ELASTIC_LOSS, once_dir=os.path.join(
                    workdir, f"once{rank}"))
                et = trainer("ckpt", ElasticConfig(restart_on_loss=True),
                             ELASTIC_LOSS_AT)
                out["losses"], out["times"] = {}, {}
                try:
                    run(et, ELASTIC_STEPS, out["losses"], out["times"])
                except SystemExit as e:
                    out["exit_code"] = e.code
                    raise
                raise AssertionError("6d: no elastic exit at the loss")
            if mode == "loss":
                faults.install(ELASTIC_LOSS, once_dir=os.path.join(
                    workdir, f"once{rank}"))
                t_s = time.perf_counter()
                et = trainer("ckpt", ElasticConfig(restart_on_loss=True), 0)
                out["build_s"] = time.perf_counter() - t_s
                out["t_ready"] = time.time()
                t_s = time.perf_counter()
                out["resumed"] = et.maybe_resume()
                torch.cuda.synchronize()
                out["restore_s"] = time.perf_counter() - t_s
                out["t_restored"] = time.time()
                out["restored_bytes"] = sum(
                    t.numel() * t.element_size()
                    for tree in (et.params, et.opt_state["m"],
                                 et.opt_state["v"]) for t in tree.values())
                out["start"] = et.step
                out["axes"] = et.plan.axes
                out["losses"], out["times"] = {}, {}
                run(et, ELASTIC_STEPS, out["losses"], out["times"])
                return 0
            faults.install(f"{ELASTIC_STRAGGLER},{ELASTIC_HANG}",
                           once_dir=None)
            h = out["hang"] = {"losses": {}, "times": {}, "replans": {}}
            t_s = time.perf_counter()
            et = trainer("hang", ElasticConfig(step_timeout=ELASTIC_BUDGET_S,
                                               hang_retries=0),
                         ELASTIC_STEPS)
            h["t_built"] = time.time()
            h["build_s"] = time.perf_counter() - t_s
            run(et, ELASTIC_HANG_STEPS, h["losses"], h["times"],
                h["replans"])
            h.update(total_replans=et.replans, world=et.world,
                     axes=et.plan.axes, restored=et.last_restore_step,
                     last_replan=et.last_replan,
                     world_size=dist.get_world_size())
            return 0
    except ElasticDeparture as e:
        out["departed"] = e.code
        raise
    finally:
        faults.uninstall()
        save()


def _launch(mode, workdir, timeout):
    """The port's launcher over two ranks of `elastic_worker(mode)`;
    raises with the workers' log tails unless it exits 0 within
    `timeout` seconds. The launcher (bound to the script's life, and its
    workers to the launcher's) and its workers share a process group of
    their own, which is killed when the launcher returns or the time
    runs out."""
    import signal
    logs = os.path.join(workdir, f"logs_{mode}")
    cmd = [sys.executable, os.path.join(HERE, "chip_smoke.py"), "--launch",
           "--nproc_per_node", "2", "--devices", "gpu",
           "--max_elastic_restart", "1", "--log_dir", logs,
           os.path.join(HERE, "chip_smoke.py"), "--elastic-worker", mode,
           workdir]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [HERE] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        _, err = proc.communicate(timeout=timeout)
        rc = proc.returncode
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        _, err = proc.communicate()
        rc = f"nothing: killed after {timeout} s"
    finally:
        try:                    # whatever is left of its group
            os.killpg(proc.pid, signal.SIGKILL)
        except OSError:
            pass
        proc.wait()
    took = time.perf_counter() - t0
    if rc != 0:
        tails = {}
        for name in sorted(os.listdir(logs)) if os.path.isdir(logs) else []:
            if name.endswith(".log"):
                with open(os.path.join(logs, name), errors="replace") as f:
                    tails[name] = f.read()[-3000:]
        raise AssertionError(f"6d {mode}: the launcher exited "
                             f"{rc}: {err[-3000:]} "
                             f"{json.dumps(tails)}")
    print(f"[chip_smoke] 6d {mode} launch: {took:.1f} s", file=sys.stderr,
          flush=True)
    return took, err


def _worker_json(workdir, mode, launch, rank):
    with open(os.path.join(workdir, f"{mode}.{launch}.rank{rank}.json")) as f:
        return json.load(f)


def elastic_drill(torch, dev, card):
    """Phase 6d (parallel/elastic.py and the launcher's degraded
    restart): fsdp2 on two ranks through the port's launcher loses a
    device at step ELASTIC_LOSS_AT's boundary; the workers exit 101 with
    the world spec {n_devices: 1} and the launcher relaunches one rank,
    which restores that step's snapshot onto fsdp1 and runs the steps
    from there to ELASTIC_STEPS. Those must equal a clean one-rank
    restore of the snapshot in this process to the bit. Then,
    on two ranks again, the uninterrupted fsdp2 run (a straggler within
    the step budget must not replan), whose same steps the resumed ones
    must lie within 1e-3 of, and after it a collective hang past the
    budget, which must replan in-process onto the surviving rank.
    Every worker's launches must be its steps' (DRILL_LAYERS layers,
    the drill's per step). Records the seconds from the loss to the
    first resumed step (detection and exit, the respawn, the boot, the
    restore, the step) and the bytes restored. Returns the train
    kernels' launches over every worker's steps."""
    import shutil
    import tempfile
    from paddle_tpu_torch.models import llama
    from paddle_tpu_torch.models.facade import make_train_step
    from paddle_tpu_torch.parallel import plan_train
    from paddle_tpu_torch.parallel.checkpoint import load_sharded
    from paddle_tpu_torch.parallel.resilience import plan_state_specs
    cfg = llama.LlamaConfig(**dict(LLAMA, num_layers=DRILL_LAYERS),
                            remat=True)
    L = cfg.num_layers
    workdir = tempfile.mkdtemp(prefix="chip_smoke_6d_")
    line = {"phase": "llama_elastic_drill", "card": card,
            "layers": DRILL_LAYERS, "fault": ELASTIC_LOSS}
    try:
        # the loss run's snapshot, then the hang run's step-ELASTIC_STEPS
        # snapshot, 12 bytes a parameter each
        n_params = sum(math.prod(v)
                       for v in llama_leaves(cfg.num_layers).values())
        line["free_disk_before"] = disk_check(workdir, 2 * 12 * n_params,
                                              "llama_elastic_drill")
        line["loss_launcher_s"], err = _launch("loss", workdir, 300)
        first = [_worker_json(workdir, "loss", "first", r) for r in (0, 1)]
        again = _worker_json(workdir, "loss", "relaunch", 0)
        if "DEGRADED world spec" not in err or again["world"] != 1:
            raise AssertionError(f"6d: no degraded relaunch: {err[-2000:]}")
        for r in first:
            if r.get("exit_code") != 101 or sorted(r["losses"], key=int) \
                    != [str(s) for s in range(ELASTIC_LOSS_AT)]:
                raise AssertionError(
                    f"6d: rank {r['rank']} exited {r.get('exit_code')}, "
                    f"not 101 after steps 0-{ELASTIC_LOSS_AT - 1}: "
                    f"{sorted(r['losses'])}")
        spec = again["granted"]
        if spec.get("n_devices") != 1 or not again["resumed"] or \
                again["start"] != ELASTIC_LOSS_AT or again["axes"] != {
                    "dp": 1, "fsdp": 1, "tp": 1}:
            raise AssertionError(f"6d: relaunch {json.dumps(again)[:2000]}")
        # the clean one-rank restore of the snapshot, in this process
        plan = plan_train(cfg, 1, LLAMA_BATCH, dp=1, fsdp=1, tp=1)
        mesh = plan.build_mesh()
        t_s = time.perf_counter()
        state = load_sharded(os.path.join(workdir, "ckpt",
                                          f"ckpt-{ELASTIC_LOSS_AT}"),
                             mesh=mesh, specs=plan_state_specs(plan),
                             device=dev)
        restore_here_s = time.perf_counter() - t_s
        with forced_registry(fused_update="pallas"):
            step = make_train_step(llama.train_step, cfg=cfg, mesh=mesh,
                                   plan=plan, **ADAMW)
            p, o = state["params"], state["opt_state"]
            step.adopt_shapes(p, o)
            clean_restore = {}
            for s in range(ELASTIC_LOSS_AT, ELASTIC_STEPS):
                loss, p, o = step(p, o, drill_tokens(torch, dev, cfg, s))
                clean_restore[s] = float(loss)
        del state, p, o, step
        torch.cuda.empty_cache()
        resumed = {int(k): v for k, v in again["losses"].items()}
        if resumed != clean_restore:
            raise AssertionError(f"6d: resumed steps {resumed} != the clean "
                                 f"restore's {clean_restore}")
        shutil.rmtree(os.path.join(workdir, "ckpt"), ignore_errors=True)
        line["hang_launcher_s"], _ = _launch("hang", workdir, 300)
        hang = [_worker_json(workdir, "hang", "first", r) for r in (0, 1)]
        h = hang[0]["hang"]
        clean_steps = [str(s) for s in range(ELASTIC_STEPS)]
        if hang[1].get("departed") != 103 or h["total_replans"] != 1 \
                or h["world"] != ["rank0"] or \
                sorted(h["losses"], key=int) != [
                    str(s) for s in range(ELASTIC_HANG_STEPS)] or \
                sorted(hang[1]["hang"]["losses"], key=int) != clean_steps \
                or any(h["replans"][s] for s in clean_steps) or \
                h["restored"] != ELASTIC_STEPS:
            raise AssertionError(f"6d: hang {json.dumps(hang)[:3000]}")
        uninterrupted = {s: h["losses"][str(s)] for s in range(ELASTIC_STEPS)}
        if any(hang[1]["hang"]["losses"][str(s)] != uninterrupted[s]
               for s in range(ELASTIC_STEPS)):
            raise AssertionError(f"6d: the fsdp2 ranks' losses differ: "
                                 f"{json.dumps(hang)[:3000]}")
        rel = max(abs(resumed[s] - uninterrupted[s]) / abs(uninterrupted[s])
                  for s in resumed)
        if rel > 1e-3:
            raise AssertionError(f"6d: resumed steps {resumed} part from the "
                                 f"uninterrupted fsdp2 run's "
                                 f"{uninterrupted} by {rel}")
        # every worker's launches: its steps' (each rank of fsdp2 and the
        # one of fsdp1 runs every layer on its rows and updates its
        # shard of each of the 11 leaves in one launch; a hung step,
        # superseded by the replan, launches nothing)
        per_step = {"flash_fwd": 2 * L, "flash_bwd_dq": L,
                    "flash_bwd_dkv": L, "ce_fwd": 1, "ce_bwd": 1,
                    "leaf_update": 1, "leaf_update_leaves": 11}
        workers = first + [again] + hang
        off = [(w["mode"], w["launch"], w["rank"], w["steps_run"],
                w["launches"]) for w in workers
               if w["launches"] != {k: w["steps_run"] * per_step.get(k, 0)
                                    for k in w["launches"]}]
        if off or [w["steps_run"] for w in workers] != [
                ELASTIC_LOSS_AT, ELASTIC_LOSS_AT,
                ELASTIC_STEPS - ELASTIC_LOSS_AT, ELASTIC_HANG_STEPS,
                ELASTIC_STEPS]:
            raise AssertionError(f"6d: launches, want steps x {per_step}: "
                                 f"{off or [w['steps_run'] for w in workers]}")
        # the last step before the loss done: the boundary
        t_loss = first[0]["times"][str(ELASTIC_LOSS_AT - 1)]
        t_first = again["times"][str(ELASTIC_LOSS_AT)]
        line.update({
            "first_launch_route": first[0]["route"],
            "first_launch_boot_s": [r["t_entry"] - r["t_spawn"]
                                    for r in first],
            "losses_before_loss": first[0]["losses"],
            "loss_run_steps_before_loss_equal_uninterrupted": all(
                first[0]["losses"][str(s)] == uninterrupted[s]
                for s in range(ELASTIC_LOSS_AT)),
            "resumed_fsdp1": resumed, "clean_restore_fsdp1": clean_restore,
            "resumed_equal_clean_restore": True,
            "uninterrupted_fsdp2": uninterrupted,
            "uninterrupted_step_s": [
                h["times"][str(s + 1)] - h["times"][str(s)]
                for s in range(ELASTIC_STEPS - 1)],
            "uninterrupted_note": "the hang launch's first ELASTIC_STEPS "
                                  "steps, under the step watchdog (the "
                                  "steps run on its thread), the "
                                  "straggler's 1 s stall in step 2",
            "max_rel_vs_uninterrupted": rel,
            "restored_bytes": again["restored_bytes"],
            "world_spec": spec, "clean_restore_s": restore_here_s,
            "loss_to_first_resumed_step_s": t_first - t_loss,
            "split_s": {
                "detect_and_exit": spec["t_exit"] - t_loss,
                "exit_to_respawn": again["t_spawn"] - spec["t_exit"],
                "respawn_to_import": again["t_import"] - again["t_spawn"],
                "boot_to_ready": again["t_ready"] - again["t_import"],
                "restore": again["t_restored"] - again["t_ready"],
                "first_step": t_first - again["t_restored"]},
            "relaunch_step_s": [again["times"][str(s + 1)]
                                - again["times"][str(s)]
                                for s in range(ELASTIC_LOSS_AT,
                                               ELASTIC_STEPS - 1)],
            "hang_launch_boot_s": [r["t_entry"] - r["t_spawn"]
                                   for r in hang],
            "hang_build_s": h["build_s"],
            "hang_first_step_s": h["times"]["0"] - h["t_built"],
            "straggler": ELASTIC_STRAGGLER, "straggler_replans": 0,
            "hang_replans": 1,
            "hang_budget_s": ELASTIC_BUDGET_S, "hang_fault": ELASTIC_HANG,
            "hang_plan": h["axes"], "hang_restored_step": h["restored"],
            "hang_replan_s": h["last_replan"],
            "hang_rank1_exit": hang[1]["departed"],
            "steps_run": [w["steps_run"] for w in workers]})
        launches = {k: sum(w["launches"][k] for w in workers)
                    for k in first[0]["launches"]}
        line["launches"] = launches
        line["flight"] = elastic_flight(workdir, first, again, hang)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    log(json.dumps(line))
    return launches


def elastic_flight(workdir, first, again, hang):
    """6d's flight-recorder and monitor checks: every worker was given
    <its launch's log dir>/flight by the launcher; each worker that met
    the loss or the hang left its 'elastic_device_loss' dump there (the
    loss run's also 'elastic_degraded_exit', with the world spec), each
    carrying the train.elastic.* family with the detection counted; the
    hang's survivor reads one replan onto a world of one. Returns what
    it read."""
    from paddle_tpu_torch.profiler.flight_recorder import load_dump
    got, bad = {}, []
    for mode, workers, reasons, counter in (
            ("loss", first, ("elastic_device_loss", "elastic_degraded_exit"),
             "device_loss"),
            ("hang", hang, ("elastic_device_loss",), "collective_hang")):
        flight = os.path.join(workdir, f"logs_{mode}", "flight")
        for w in workers:
            if w["flight_dir"] != flight:
                bad.append(f"{mode} rank {w['rank']}: flight dir "
                           f"{w['flight_dir']}")
                continue
            for reason in reasons:
                path = os.path.join(flight, f"flight-{w['pid']}-{reason}.json")
                try:
                    doc = load_dump(path)
                except (OSError, ValueError) as e:
                    bad.append(f"{mode} rank {w['rank']}: {e!r}")
                    continue
                mon = {k: v for k, v in doc["monitor"].items()
                       if k.startswith("train.elastic.")}
                got[f"{mode}.rank{w['rank']}.{reason}"] = mon
                if mon.get(f"train.elastic.{counter}") != 1:
                    bad.append(f"{mode} rank {w['rank']} {reason}: {mon}")
    if again["flight_dir"] != os.path.join(workdir, "logs_loss", "flight"):
        bad.append(f"relaunch: flight dir {again['flight_dir']}")
    survivor = hang[0]["elastic"]
    got["hang.survivor"] = survivor
    if survivor.get("train.elastic.replans") != 1 or \
            survivor.get("train.elastic.world_size") != 1 or \
            not survivor.get("train.elastic.reshard_bytes"):
        bad.append(f"hang survivor: {survivor}")
    if bad:
        raise AssertionError(f"6d flight and monitor: {bad}")
    return got


def kernels_line(rows, attn_rows, ce_rows, pair_rows, upd_rows,
                 gpt_launches, llama_launches, serving_launches, f64,
                 replay_launches, race_launches, tiles, sharded, tf_rows,
                 sampler, tp_rows):
    """The kernels line: every kernel with its route, source, the TPU
    kernel it replaces, its launches on the main paths, and its times,
    bound and error from the kernel checks. `serving_launches` is the
    int8 kernel's {path: launches} through its wrapper,
    `replay_launches` its {path: launches inside CUDA graph replays};
    `f64` the worst of its f64 bound check; `race_launches` the train
    kernels' launches over phase 3b; `tiles` the forward's times at both
    q tiles and the autotune's picks; `sharded` the train kernels'
    {path: launches} of phase 6 (6a's 5 steps; 6b's, both ranks and
    its 3D plans summed, and its pipelined plan's; 6c (a)'s 8 steps and
    the drill's steps, skipped ones included, and 6d's workers' steps);
    `tf_rows` the threefry kernel's check rows, `sampler` its launches
    by serving phase; `tp_rows` the int8 kernel's rows at a tp2 rank's
    leaf shapes (phase 5e)."""

    def train_paths(name):
        paths = {"gpt_train": gpt_launches[name],
                 "llama_train": llama_launches[name],
                 "gpt_race": race_launches[name]}
        paths.update({path: c[name] for path, c in sharded.items()})
        return paths
    nums = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
            "max_abs_err")

    def on_shards(table, shapes, kernel):
        """{plan: the kernel's numbers at a rank's shape under it}"""
        return {name: {k: table[sh][kernel][k] for k in nums}
                for name, sh in shapes.items()}
    agg = tick_aggregate(rows, LEAF_KN, FULL["num_layers"])
    l_agg = tick_aggregate(rows, LLAMA_LEAF_KN, LLAMA["num_layers"])
    # the int8 launches of a Llama serving pass and spec tick
    lpass = sum(pass_calls(LLAMA_LEAF_KN, LLAMA_SERVE_LAYERS).values())
    lspec = lpass + SPEC["gamma"] * sum(
        pass_calls(LLAMA_LEAF_KN, SPEC["draft_layers"]).values())
    entries = [{
        "name": "quant_matmul", "route": "cuda",
        "source": "paddle_tpu_torch/kernels/csrc/quant_matmul.cu",
        "replaces": "paddle_tpu/kernels/quant_matmul.py:181",
        "launches": sum(serving_launches.values()),
        "launches_by_path": serving_launches,
        "replay_launches_by_path": replay_launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows.values()),
        "ms": agg["kernel_ms"], "plain_ms": agg["plain_ms"],
        "bound_ms": agg["bound_ms"], "bound_by": agg["bound_by"],
        "library_ms": agg["library_ms"], "design": QMM_DESIGN,
        "llama_tick": {k: l_agg[k] for k in ("calls", "kernel_ms",
                                             "plain_ms", "bound_ms",
                                             "bound_by", "library_ms")},
        "f64_bound": f64,
        "tp2_shapes": {f"{K}x{N}": {
            "ms": r["kernel_ms"], "plain_ms": r["plain_ms"],
            "library_ms": r["library_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "max_abs_err": r["max_abs_err"]}
            for (K, N), r in tp_rows.items()},
        "per": "one GPT decode tick at M=8: 24 layers x 4 leaves + the head "
               "(97 launches); llama_tick: a full-depth tick, 22 x 7 + 1 "
               "= 155; from the "
               "kernel_check lines; launches over the 16-request serving "
               f"run of each family (Llama's at LLAMA_SERVE_LAYERS = "
               f"{LLAMA_SERVE_LAYERS} layers: {lpass} a pass), of phase "
               f"5c's paged and paged spec engines ({lspec} a spec tick), "
               "and of phase 5d's multi-tick "
               "engines and host tier runs (at the same depth), where the "
               "wrapper counts the prefills and each "
               f"sampling flag's eager warm-up dispatch (4 x {lpass} or "
               f"4 x {lspec}) and the CUDA graph replays launch "
               "the rest: replay_launches_by_path, replays x 4 x the "
               "tick's calls (each capture checked to record exactly "
               "4 x the tick's calls), and for the four 5d engines the "
               "launches the profiler listed over their profiled replays, "
               "checked at 99-100% of the engine's count (the profiler "
               "drops a few records late in the process); llama_tp2 and "
               "llama_tp2_spec: phase 5e's tp2 engines, both ranks' "
               f"launches summed ({lpass} a pass and {lspec} a spec tick "
               "a rank), "
               "at the tp2_shapes (M 8, each also held to the f64 bound)",
    }]
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    replaces = {"flash_fwd": "paddle_tpu/kernels/pallas_attention.py:119",
                "flash_bwd_dq": "paddle_tpu/kernels/pallas_attention.py:310",
                "flash_bwd_dkv":
                    "paddle_tpu/kernels/pallas_attention.py:327"}
    for name, where in replaces.items():
        main_row = attn_rows[ATTN_LLAMA][name]
        entries.append({
            "name": name, "route": "cuda",
            "source": "paddle_tpu_torch/kernels/csrc/flash_attention.cu",
            "replaces": where,
            "launches": sum(train_paths(name).values()),
            "launches_by_path": train_paths(name),
            "max_abs_err": max(r[name]["max_abs_err"]
                               for r in attn_rows.values()),
            **{k: main_row[k] for k in keys},
            "on_shards": on_shards(attn_rows, SHARDED_ATTN, name),
            "design": main_row["design"],
            "per": "one call at the Llama train step's [4, 2048, 32, 64] "
                   "bf16 causal (the GPT step's [8, 1024, 16, 64] is in "
                   "its kernel_check line); launches over the 10 timed "
                   "steps of each train path, over phase 3b's timed "
                   "and route steps (gpt_race), over phase 6's 5 "
                   "steps on one rank and on two (both ranks, the 3D "
                   "plans, and the pipelined plan; SHARDED_LAYERS = "
                   f"{SHARDED_LAYERS} layers), over 6c (a)'s 8 "
                   f"steps and the resilience drill's 16 ({DRILL_LAYERS} "
                   "layers, skipped steps included), and over every step "
                   f"of 6d's launcher workers ({DRILL_LAYERS} layers); "
                   "on_shards: at a "
                   "rank's [B, S, H, 64] under each of phase 6b's plans "
                   "(SHARDED_ATTN: a "
                   "microbatch's [1, 2048, 32, 64] under pp2; a Ulysses "
                   "sp2 rank's [8, 1024, 8, 64]), checked "
                   "as the main shape is; gpt_moe_train: phase 3c's 10 "
                   "timed steps (MOE_LAYERS "
                   "layers, 8 experts), gpt_moe_gshard_step: its one "
                   "gshard step; gpt_<plan>_2rank: 6b's GPT plans "
                   "(GPT_PLAN_STEPS steps, both ranks summed)"})
        if name == "flash_fwd":
            entries[-1]["tiles"] = tiles
            entries[-1]["tiles_note"] = (
                "ms of the forward at each (block_q x block_k) tile and "
                "the autotune's pick, at the GPT step's [8, 1024, 16, 64] "
                "and the Llama step's [4, 2048, 32, 64]; ms above is the "
                "default tile (128 x 64)")
    ce_main = ce_rows[CE_SHAPES[0]]
    entries.append({
        "name": "fused_ce", "route": "cuda",
        "source": "paddle_tpu_torch/kernels/csrc/fused_ce.cu",
        "replaces": "paddle_tpu/kernels/pallas_ce.py:143",
        "launches": sum(train_paths("fused_ce").values()),
        "launches_by_path": train_paths("fused_ce"),
        "max_abs_err": max(r["max_abs_err"] for r in ce_rows.values()),
        **{k: ce_main[k] for k in keys},
        "plan": ce_main["plan"],
        "design": CE_DESIGN,
        "on_shapes": {f"{T}x{V} {dtype}": {k: r[k] for k in nums + ("plan", "tolerance")}
                      for (T, V, dtype), r in ce_rows.items()},
        "per": "one call at the GPT train step's [8192, 32768] bf16 "
               "logits; launches over the 10 timed steps of each train "
               "path (the GPT path forces this route); on_shapes: every "
               "CE_SHAPES check with its plan and tolerance"})
    pair_main = pair_rows[CE_PAIR_SHAPES[0]]
    for name, where in (("ce_fwd", "paddle_tpu/kernels/pallas_ce.py:179"),
                        ("ce_bwd", "paddle_tpu/kernels/pallas_ce.py:218")):
        entries.append({
            "name": name, "route": "cuda",
            "source": "paddle_tpu_torch/kernels/csrc/fused_ce.cu",
            "replaces": where,
            "launches": sum(train_paths(name).values()),
            "launches_by_path": train_paths(name),
            "max_abs_err": max(r[name]["max_abs_err"]
                               for r in pair_rows.values()),
            **{k: pair_main[name][k] for k in keys},
            "on_shards": on_shards(pair_rows, SHARDED_CE, name),
            "per": "one call at the Llama train step's [8192, 32000] bf16 "
                   "logits; launches over the 10 timed steps of each "
                   "train path and phase 6's steps (6c and the drill "
                   "included); on_shards: at a "
                   "rank's [T, 32000] under each of phase 6b's 3D plans "
                   "(SHARDED_CE; the pipelined step launches none); the "
                   "GPT paths' logits are [8192, 32768], in its "
                   "kernel_check line; gpt_moe_train: phase 3c's 10 "
                   "timed steps (MOE_LAYERS "
                   "layers, 8 experts), gpt_moe_gshard_step: its one "
                   "gshard step; gpt_<plan>_2rank: 6b's GPT plans "
                   "(GPT_PLAN_STEPS steps, both ranks summed)"})
    upd = upd_rows["step"]
    entries.append({
        "name": "leaf_update", "route": "cuda",
        "source": "paddle_tpu_torch/kernels/csrc/fused_update.cu",
        "replaces": "paddle_tpu/kernels/pallas_update.py:87",
        "launches": sum(train_paths("leaf_update").values()),
        "launches_by_path": train_paths("leaf_update"),
        "leaves_by_path": train_paths("leaf_update_leaves"),
        "design": UPDATE_DESIGN,
        "max_abs_err": max([upd["max_abs_err"]] + [
            r["max_abs_err"] for r in upd_rows["sharded"].values()] + [
            r["max_abs_err"] for r in upd_rows["gpt"].values()]),
        **{k: upd[k] for k in keys},
        "on_shards": {name: {k: r[k] for k in nums}
                      for name, r in upd_rows["sharded"].items()},
        "on_gpt_trees": {name: {"leaves": int(r["leaf"].split()[-1]),
                                "n": r["n"], **{k: r[k] for k in nums}}
                         for name, r in upd_rows["gpt"].items()},
        "per": "one Llama step's update: one leaves_update over the 11 "
               "leaves of the TinyLlama-width tree in f32, one launch "
               "(library: one torch._fused_adamw_ call over all 11); "
               "launches over the 10 timed steps of each train path and "
               "phase 6's steps (on local shards; 6c and the drill "
               "included), one a step a rank, and leaves_by_path the "
               "leaves they updated, 11 a step a rank; "
               "on_shards: one rank's update of its "
               "11 shards under each of phase 6b's plans (shard_shapes, "
               f"SHARDED_LAYERS = {SHARDED_LAYERS} layers; "
               "under pp2 a stage's half of each stacked leaf and the "
               "whole wte and norm_f); the GPT paths update 17 leaves a "
               "step with experts, 16 without; on_gpt_trees: one "
               "leaves_update over phase 3c's MoE tree (gpt_moe, "
               "GPT_MOE_LEAVES) and over a rank's shards under 6b's GPT "
               "plans (gpt_plan_shapes), each held to the plain version "
               "within 1 ulp and timed beside it and one "
               "torch._fused_adamw_ call; gpt_moe_train: phase "
               "3c's 10 timed steps (MOE_LAYERS layers, 8 experts), "
               "gpt_moe_gshard_step: its one gshard step; "
               "gpt_<plan>_2rank: 6b's GPT plans (GPT_PLAN_STEPS steps, "
               "both ranks summed)"})
    tf_main = tf_rows[THREEFRY_SHAPES[0]]
    entries.append({
        "name": "threefry_bits", "route": "cuda",
        "source": "paddle_tpu_torch/kernels/csrc/threefry.cu",
        "replaces": "paddle_tpu/inference/serving.py:546",
        "replaces_note": "jax.random.categorical (:546, :554): XLA's "
                         "threefry; the reference has no Pallas kernel "
                         "here",
        "launches": sum(d["launches"] for d in sampler.values()),
        "launches_by_path": {k: d["launches"] for k, d in sampler.items()},
        "captured_into_graphs": sum(d["captured"] for d in sampler.values()),
        "replay_launches": sum(d["replayed"] for d in sampler.values()),
        "max_abs_err": max(r["max_abs_err"] for r in tf_rows.values()),
        **{k: tf_main[k] for k in keys},
        "llama_draw": {k: tf_rows[THREEFRY_SHAPES[1]][k] for k in nums},
        "design": THREEFRY_DESIGN,
        "per": "one draw of the sampled decode tick at GPT's [8, 32768] "
               "(llama_draw: [8, 32000]), the slot keys' two fold_ins "
               "included; launches over each serving phase's main-path "
               "runs through the wrapper, exactly one a sampled tick or "
               "prefill pass (check_draws; the top-k draw reuses the full "
               "draw's first K columns); captured_into_graphs: recorded "
               "into 5d's CUDA graphs, replay_launches: run by their "
               "replays; no library call computes these bits (torch's "
               "generators are Philox)"})
    return {"kernels": entries}


def main():
    if len(sys.argv) > 3 and sys.argv[1] == "--elastic-worker":
        return elastic_worker(sys.argv[2], sys.argv[3])
    if len(sys.argv) > 2 and sys.argv[1] == "--fleet-crash-child":
        return fleet_crash_child(sys.argv[2])
    if len(sys.argv) > 1 and sys.argv[1] == "--launch":
        # 6d's launcher, bound to the script's life (`_launch`)
        bind_to_script()
        sys.path.insert(0, HERE)
        from paddle_tpu_torch.distributed.launch.main import main as launch
        sys.argv = [sys.argv[0]] + sys.argv[2:]
        return launch()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing to run",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    stop_before_limit()
    try:
        return run(torch)
    finally:
        left = stop_descendants(keep=(RESOURCE_TRACKER,))
        if left:
            print(f"[chip_smoke] stopped {len(left)} process(es) left "
                  f"below the script: {json.dumps(left)}", file=sys.stderr,
                  flush=True)


def run(torch):
    """Every phase in order; 0 when all passed (a failed check raises)."""
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import quant_matmul as qm

    t_start = time.perf_counter()
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("tf32: off for matmul and cuDNN (plain versions run in full f32)")

    t0 = time.perf_counter()
    _build.build(*_build.KERNELS)
    log(f"build: {time.perf_counter() - t0:.1f} s (one nvcc per source, "
        f"in parallel)")
    for name, rec in _build.build_logs.items():
        how = "cached" if rec["cached"] else f"{rec['seconds']:.1f} s"
        log(f"nvcc -Xptxas -v summary for {name} ({how}):")
        for line in ptxas_summary(rec["ptxas"]):
            log("  " + line)
    check_no_spills(_build.build_logs["flash_attention"]["ptxas"])
    check_no_spills(_build.build_logs["quant_matmul"]["ptxas"],
                    QMM_NO_SPILL)
    log("ptxas: no spills in the D = 64 bf16 attention kernels (the "
        "forward at both q tiles) or the bf16 dequant-matmul")

    # the rank's own card: LOCAL_RANK where a launcher sets it, else the
    # current device
    from paddle_tpu_torch.device import resolve_device
    dev = resolve_device(None)
    # device memory still allocated after each phase: what a later
    # phase's peak reading starts from
    held = {}
    # seconds each phase took, printed as it ends
    seconds = {"build": time.perf_counter() - t_start}

    def phase(name, fn, *args):
        t_s = time.perf_counter()
        out = fn(*args)
        held[name] = torch.cuda.memory_allocated()
        seconds[name] = time.perf_counter() - t_s
        log(f"{name}: {seconds[name]:.1f} s")
        # on the standard error too, where a run cut at its time limit
        # shows how far it got
        print(f"[chip_smoke] {name}: {seconds[name]:.1f} s (at "
              f"{time.perf_counter() - t_start:.1f} s of {TIME_LIMIT_S})",
              file=sys.stderr, flush=True)
        return out
    rows = phase("kernel_check", kernel_check, torch, qm, dev)
    f64 = phase("qmm_f64_check", qmm_f64_check, torch, qm, dev)
    attn_rows = phase("attention_check", attention_check, torch, dev)
    phase("attention_oracle", attention_oracle, torch, dev)
    ce_rows = phase("ce_check", ce_check, torch, dev)
    pair_rows = phase("ce_pair_check", ce_pair_check, torch, dev)
    upd_rows = phase("update_check", update_check, torch, dev)
    tf_rows = phase("threefry_check", threefry_check, torch, dev)
    # the threefry kernel's launches by serving phase: the sum of its
    # main paths' runs, each counted from 0 where the run starts and
    # held to the sampler's draws (check_draws)
    sampler = {}

    def sampling_phase(name, fn, *args):
        DRAWS.update(launches=0, captured=0, replayed=0)
        out = phase(name, fn, *args)
        sampler[name] = dict(DRAWS)
        return out
    gpt_launches = phase("gpt_train", training, torch, dev, card)
    race_launches = phase("gpt_race", race, torch, dev, card)
    tiles = phase("flash_fwd_tiles", autotune_tiles, torch, dev, card)
    moe, moe_gshard = phase("gpt_moe_train", moe_training, torch, dev, card)
    moe_paths = {"gpt_moe_train": moe, "gpt_moe_gshard_step": moe_gshard}
    llama_launches, p4 = phase("llama_train", llama_training, torch, dev,
                               card)
    # phases 5 and 5f share the host-drawn GPT weights and their int8
    # rewrite
    gcfg, gparams = gpt_host_params()
    with quantize_once():
        serving_launches = {
            "gpt_serving": sampling_phase("gpt_serving", serving, torch, qm,
                                          dev, card, gcfg, gparams)[0]}
        serving_launches["gpt_serving_chaos"], chaos_replays = \
            sampling_phase("gpt_serving_chaos", gpt_serving_chaos, torch,
                           qm, dev, card, gcfg, gparams)
        serving_launches["gpt_fleet"], fleet_replays = sampling_phase(
            "gpt_fleet", gpt_fleet, torch, qm, dev, card, gcfg, gparams)
    del gparams
    # phases 5b-5e share the host-drawn TinyLlama-width weights at
    # LLAMA_SERVE_LAYERS layers and their int8 rewrite
    lcfg, lparams = llama_host_params()
    with quantize_once():
        serving_launches["llama_serving"], k1 = sampling_phase(
            "llama_serving", llama_serving, torch, qm, dev, card, lcfg,
            lparams)
        paged_launches, k1c = sampling_phase(
            "llama_paged", paged_serving, torch, qm, dev, card, lcfg,
            lparams)
        serving_launches.update(paged_launches)
        k1c["serving"] = k1
        mt_launches, replay_launches = sampling_phase(
            "llama_multi_tick", multi_tick_serving, torch, qm, dev, card,
            lcfg, lparams, k1c)
        serving_launches.update(mt_launches)
        replay_launches["gpt_serving_chaos"] = chaos_replays
        replay_launches["gpt_fleet"] = fleet_replays
        tp_launches, tp_draws, tp_rows, _ = phase(
            "llama_tp2_serving", tp_serving, torch, qm, dev, card, lcfg,
            lparams, k1c)
        serving_launches.update(tp_launches)
        sampler.update(tp_draws)
        del k1, k1c
        serving_launches["llama_host_tier"], tier_replays = sampling_phase(
            "llama_host_tier", host_tier_serving, torch, qm, dev, card,
            lcfg, lparams)
        replay_launches["llama_host_tier"] = {"replays": tier_replays}
    del lparams
    # every serving phase with sampled requests drew through the kernel
    # (the host tier's requests are greedy)
    unsampled = [k for k in SAMPLING_PHASES
                 if not sampler[k]["launches"] + sampler[k]["captured"]]
    if unsampled:
        raise AssertionError(f"no threefry kernel launch in {unsampled}: "
                             f"{sampler}")
    p6a = phase("llama_sharded_1rank", sharded_one_rank, torch, dev, card,
                p4)
    two, gpt_two = phase("llama_sharded_2rank", sharded_two_ranks, torch,
                         card)
    sharded = {"llama_sharded_1rank": p6a["launches"]}
    sharded.update(moe_paths)
    for name, ranks in gpt_two.items():
        sharded[f"gpt_{name}_2rank"] = {k: sum(c.get(k, 0) for c in ranks)
                                        for k in p6a["launches"]}
    for path, pp in (("llama_sharded_2rank", False),
                     ("llama_pipelined_2rank", True)):
        sharded[path] = {k: sum(c[k] for name, ranks in two.items()
                                if (plan_pp(name) > 1) == pp
                                for c in ranks)
                         for k in p6a["launches"]}
    sharded["llama_checkpoint_resume"] = phase(
        "llama_checkpoint_resume", checkpoint_resume, torch, dev, card, p4)
    sharded["llama_resilience_drill"] = phase(
        "llama_resilience_drill", resilience_drill, torch, dev, card)
    sharded["llama_elastic_drill"] = phase(
        "llama_elastic_drill", elastic_drill, torch, dev, card)
    log(json.dumps({"phase": "memory_allocated_after", **held}))
    total = time.perf_counter() - t_start
    log(json.dumps({"phase": "seconds", **seconds, "total": total,
                    "limit": TIME_LIMIT_S,
                    "margin_s": TIME_LIMIT_S - total}))
    kernels = kernels_line(rows, attn_rows, ce_rows, pair_rows, upd_rows,
                           gpt_launches, llama_launches, serving_launches,
                           f64, replay_launches, race_launches, tiles,
                           sharded, tf_rows, sampler, tp_rows)
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    log(json.dumps(kernels))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
