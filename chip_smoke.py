#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (``src/repro_torch``) on one GPU.

Run from the repository root on a machine with one CUDA card (an H100) and
``nvcc``::

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result:

1. build  — compiles every kernel of ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per source, all at once) and prints the build seconds and the
   card's ``nvidia-smi`` name and power limit;
2. parity — each kernel against its plain PyTorch version on the card, at
   edge-case shapes: exact where the reference is exact (counts, min, max,
   top-k values, compacted bytes), float32 sums within 1e-5 of Σ|x| (per
   row for masked_stats, per bucket for segment_reduce) and m2 within 1e-4
   relative, plus bit equality for pad invariance, batched == per-row and
   fused == unfused (masked_stats also: batched == per-row copies at other
   alignments, at n = 3, five rows of 16,385 (each starting at another
   16-byte offset), one live value in the last tile, ±inf and NaN in
   masked lanes, and slices 4 bytes past a boundary, alone and through
   ``masked_stats_batch_parts``; topk also: sorted rows both ways at k 20
   and 128, one value repeated, fewer than k finite values, k 128 at n 129,
   three rows of 4,097, an unaligned slice, and rows with NaN (NaN equal
   to NaN: [1, NaN, 3, 2, -1] at k 2, one NaN, k + 1 NaNs, NaNs beside
   +inf and -inf, on one launch and on two); every call must launch its
   kernel; segment_reduce also: two calls equal, and bucket
   independence, at shapes that include one bucket of 2^21 rows, Zipf keys
   at cell 7's size, no valid row, keys out of range and B = 2^24 - 1);
   join_probe exact for every key type with right sides staged whole and
   sampled, and at the sample's edges with the step forced (fewer keys than
   a step, a count no multiple of it, a NaN tail over a sample point, keys
   at sample points); ssd_chunk_scan at its shapes (full width, f32, one-
   token chunks, the tensor-core route's edges: L 64, P 128, N 64, batch
   2, P 16, a head count its group size does not divide; and the short
   route's: f32 at L 1, L 2 and 16 (its threshold), P 24 and 40, N 17 with
   P 7, batch 2, a head count its group does not divide, L 17 past it; at
   one-token chunks also N 256 (``ssd_recur``'s limit), N 17 with P 7 in
   batches of 2 over 3 heads, and S = 1): each call at one-token chunks on
   ``ssd_recur`` once and no other kernel, h_final bit for bit, each other
   call on the kernel ``ssd_route`` names and on the inter-chunk scan kernel
   ``ssd_scan`` once; then at each shape the intra-chunk kernel alone
   (``ssd_short`` at L 1-16, its one-token chunk states equal to the plain
   version's bit for bit) and ``ssd_scan`` alone on its outputs against the
   plain inter-chunk pass: h_final bit for bit, y by check_ssd; then
   the flash_attention forward (bf16 on the tensor-core kernel
   ``attn_fwd_wgmma``, float32 on the FMA kernel ``attn_fwd``; each launch
   must take the kernel ``forward_route`` names) and its backward (bf16 on
   ``attn_bwd_dq_wgmma`` and ``attn_bwd_dkdv_wgmma``, float32 on the FMA
   kernels; each launch must take the kernels ``backward_route`` names)
   against the plain attention (output and all three gradients) at
   edge shapes (GQA groups 1, 3, 4, 8; D 64, 120, 128; bf16 and f32; causal
   or not; windows 32 and 4,096; q_offset > 0 with Sq < Skv, down to one
   128-row q tile with only 64 rows live; one tile; danube's heads over
   4,096 keys; B 1 to 4; and at D 256 and 192: MQA group 16 with a window
   of 2,048 over 4,096 keys in both types, window 32, not causal, q_offset
   > 0, a ragged 96-row sequence), two backward runs equal bit for bit, and two
   faulty plain attentions (no alpha rescale; a dK/dV that drops a head)
   over the limits; a forward and backward in a new thread equal the same
   call in the main one; then the SSD's backward (phase 2c), its three
   launches (the state and chunk kernels of the route ``bwd_route`` names,
   ``ssd_bwd_state_wgmma`` and ``ssd_bwd_chunk_wgmma`` on the tensor cores
   for the bf16 shapes at chunks of 128 and 64, ``ssd_bwd_state`` and
   ``ssd_bwd_chunk`` in float32 FMA for the rest, each shape's route
   printed and checked, then ``ssd_bwd_sum``) against
   the plain backward (dx, dlog_a, db, dc, and the state kernel's h_in and
   g) and both against float64 autograd of the plain forward, at
   mamba2_2p7b's training launch (1 x 4,096 x 80 x 64, N 128, chunk 128,
   bf16), in float32, at chunks of 64, 96 (one chunk), 16 and 1 (the
   chunk-1 rule), N 17 with P 7, N 256 with P 128 over 7 heads, batches of
   2, dh given and absent, decays slow enough that the gradient carried
   between chunks counts; each call one launch of each of its route's
   kernels (the route's launch counters read), a repeat
   equal bit for bit, the plain backward that drops the carry D_k g_k over
   the limits, and ``ssd_chunk_scan``'s autograd route equal to the
   wrapper's gradient bit for bit;
3. main path — a 10M-row table and a 900,000-row dimension table through a
   seven-cell notebook (describe, filter + groupby, value_counts, sort +
   head, head, a left join + head, and an inner join + a groupby over
   100,000 segments) in a ``cuda`` session and a ``numpy`` session; answers
   must agree, every dataframe kernel must have launched, and no kernel may
   have failed or fallen back to numpy.  The notebook then runs once more
   under torch.profiler, which prints per cell the wall time beside the
   device time in kernels and in copies;
3c. data mesh — the same seven cells over ``dist.use_mesh([cuda:0] * 4)``
   (the port's data mesh emulated as four shards on one card, two of the 8
   partitions a shard) under ``dist.use_sharded("on")``, each answer bit for
   bit against the same cells under ``"off"`` (the host path) on the same
   catalog, and a ``df.mean()`` declared, computed in think time as one
   sharded UnitBatch (the executor's ``sharded_batches``) and then shown: a
   sharded call of every family the cells reach (stats, stats_raws,
   value_counts, topk, groupby, join build and probe), the kernel each must
   launch counted inside it (masked_stats, segment_reduce, topk,
   join_probe), no ``"sharded"`` breaker failure; each cell's wall beside
   the host path's, and the cells traced once more.  Then, under ``"auto"``, a join against the
   4,000,000-row ``accounts`` (32 MB of int64 keys, above
   ``JOIN_BROADCAST_MAX_BYTES``) takes the partition-parallel build by its
   size alone while describe stays on the host path (``no_estimate``: the
   port has no priors).  With 2^k >= 2 cards the cells run once more over
   ``data_mesh()``; on one card that branch says it did not run;
3d. engine contracts — on the same 10M-row ``events`` in cuda sessions,
   one alive at a time but where a check compares two: (a)
   ``warm_device_cache`` of the materialised table (its ms and the bytes it
   adds), then cells 1-5 profiled, bit for bit phase 3's unwarmed answers,
   describe copying under 1 MiB host → device (each cell's wall beside
   phase 3's, its host → device copy ms and bytes); (b) describe, a groupby
   and value_counts as progressive interactions, a first estimate below
   full coverage and ``upgrade()`` bit for bit a fresh session's ``show``;
   (c) five nodes drained in think time with and without batching, bit for
   bit, batched units only in the first; (d) three filter chains with the
   cost model calibrated (injected samples) so that each ``fused:`` key is
   lowered on cuda, bit for bit a ``planner=False`` session; (e) every
   background unit failing: cells 1-4 bit for bit phase 3's; half the
   background kernel dispatches failing: within the parity tolerances of
   the numpy session, a ``|cuda`` breaker failure and samples labelled as
   served by numpy; the phase's launches join the JSON line's;
3b. examples — ``examples/torch_quickstart.py`` and
   ``torch_interactive_session.py`` called in-process (``main()``) in a
   cuda session and in a numpy session: answers within the parity
   tolerances of tests/test_backend_parity.py:51-54, the simulated
   latencies equal, the first dispatch of each planner key on the kernels,
   masked_stats (both), segment_reduce and filter_compact (the second)
   launched, no breaker failure; the planner's decisions and the launches
   printed.  ``torch_serve_opportunistic.py``, ``repro_torch.launch.serve``
   and ``torch_train_lm.py`` (200 steps) at smoke width, each twice: tokens,
   latencies and losses equal bit for bit;
4. real mode — the first two cells with the background worker running;
4b. serving — ``mamba2_2p7b`` at full width (random weights from a seed)
   behind an ``OpportunisticServer``: a cold 1,024-token request, an
   anticipated prompt prefilled in think time and then requested, its
   resubmission (a cache hit), and a 1,000-token request (the one-token-
   chunk rule).  Every prefill must launch ``ssd_chunk_scan`` once per
   layer: the two 1,024-token ones on the tensor-core kernel ``ssd_wgmma``
   and the inter-chunk scan kernel ``ssd_scan``, the 1,000-token one on
   ``ssd_recur`` alone; none on ``ssd_short`` or ``ssd_cells``, and the
   plain inter-chunk pass (a loop over the chunks) never; the
   warm answer must equal a cold recompute.  At both prompt lengths every
   layer's SSD, on the model's own inputs (those of the plain prefill),
   must pass check_ssd's limits against the plain SSD, which two faulty
   plain SSDs (one dropping the chunk states, one rounding its
   intermediates to bf16) must fail at every layer; the logits at every position of the model cut to one layer
   must lie within two bf16 ulps of the plain SSD's and within a distance
   that two plain SSDs differing in rounding alone (float64; the time axis
   summed in reverse) must keep and both faulty ones must cross (see
   LOGITS_LINE); at 1,024 tokens and full depth the top token must agree.
   The 1,000- and 1,024-token prefills are timed alone, the 1,000-token
   one also with the pair ``ssd_short`` + ``ssd_scan`` forced, in turns
   with ``ssd_recur``; profiled
   prefills of both lengths and a decode split the time by kernel, with
   the inter-chunk scan's wrapper as a profiler range (its host and device
   time);
4c. training — ``smollm_360m`` at full width (random weights from seed 12,
   float32 master weights) trained by ``train_loop`` for 4 steps of 8 x
   4,096 tokens (microbatch 4, remat full, a checkpoint every 2 steps):
   finite losses and gradient norms, 128 forward launches a step, every one
   of them on ``attn_fwd_wgmma``, and 64 + 64 backward attention launches,
   every one of them on ``attn_bwd_dq_wgmma`` and ``attn_bwd_dkdv_wgmma``,
   one profiled step split by kernel; the same
   step twice from the same state equal bit for bit; one microbatch's loss,
   gradient norm and gradients against the plain attention's (and a faulty
   plain attention over the limit); a run killed by ``fail_at_step=3``
   resumes and ends bit for bit where the uninterrupted run ended;
4d. hybrid serving — ``granite_moe_3b_a800m`` (32 layers, 40 experts, top
   8) and ``recurrentgemma_9b`` (38 layers) at full width and depth, random
   weights from a seed, behind an ``OpportunisticServer``: the requests of
   4b at 1,024 tokens (cold, anticipated and prefilled in think time, its
   resubmission), RecurrentGemma also a 2,048-token prompt (it fills the
   local-attention ring; its decode steps wrap it); no attention kernel may
   launch (the cached branch is the plain path); warm equal to a cold
   recompute, and the same requests in a fresh server equal in tokens and
   last logits bit for bit.  granite: layer 0's ``moe_ffn`` on the model's
   own inputs within 2^-5 of the largest |y| of float64 on the CPU at the
   tokens whose experts agree (any other token a near tie), the assignments
   dropped at capacity the same on the card and by the CPU's dispatch, and
   one layer-0 ``moe_ffn`` forward under ``set_sync_debug_mode("error")``
   (no host synchronization: ROADMAP C12).
   RecurrentGemma cut to one pattern group: 2,176 decode steps from
   position 0 against one cache-free forward (the D 256 forward kernel),
   every position within 2^-5 of the largest |logit|.  Request walls,
   decode ms a token (a prefill with 16 decode steps against one alone,
   timed), and profiled prefills and 2-step decodes split by kernel;
4e. hybrid training — ``recurrentgemma_9b`` at full width cut to one
   pattern group (2.69e9 parameters, float32 master weights, AdamW in
   place) trained by ``train_loop`` for 4 steps of 1 x 4,096 tokens (remat
   full): finite losses and gradient norms, 2 forward launches a step on
   ``attn_fwd_wgmma`` and 1 of each backward kernel on the tensor-core
   kernels (D 256), the peak device memory; the same step twice from one
   state equal bit for bit (the first state kept on the host), one step
   profiled; one microbatch's loss, gradient norm and gradients against the
   plain attention's (and the faulty plain attention over the limit);
4f. MoE training — ``granite_moe_3b_a800m`` at full width cut to 8 of its
   32 layers (0.96e9 parameters, float32 master weights) trained through
   ``train_loop`` as the train launcher drives it (``train_cut``) for 4
   steps of 8 x 4,096 tokens (microbatch 4, remat full, seed 12): finite losses, step
   times, tokens/s and the peak device memory beside its prediction; 32
   forward and 16 + 16 backward attention launches a step, every one on the tensor-core
   kernels; the assignments dropped at capacity counted; a run killed at
   step 2 resumed from its step-2 checkpoint with the uninterrupted run's
   losses and end-state fingerprint (every leaf's two 64-bit checksums);
   the same step twice from one state equal bit for bit (the first state
   kept on the host), one step profiled (attention, GEMMs, the MoE layer's
   sort / gather / scatter / index kernels, other, idle share); one
   microbatch with the kernels against the plain attention, the plain run
   on the kernel run's experts (the tokens whose router would take others
   counted), every leaf held, and the faulty plain attention over the limit;
4g. the model mesh — four shards emulated on the card, as phase 3c
   emulates the data mesh.  (a) ``granite_moe_3b_a800m`` at full width cut
   to 16 of its 32 layers at ``ShardCtx(tp=4)`` (40 experts, ten a shard; vocab padded to
   49,184) served through ``make_serve_fns`` over ``make_mesh(1, 4,
   devices=[cuda:0] * 4)`` expert-parallel: a 1,024-token prefill and 16
   greedy decode steps, beside the same context with no mesh; every
   decode step split-S on each shard's kv heads in all 16 attention layers
   and four shard calls a layer, each with its ten experts on its shard's
   device, the caches by kv heads; a fresh mesh repeats tokens and last logits bit
   for bit; layer 0's ``moe_ffn_sharded`` on the model's own inputs under
   ``set_sync_debug_mode("error")``, against ``moe_ffn`` within 2^-5 of the
   largest |y| with the same kept and dropped assignments; one split-S
   decode step of layer 0 within 2e-2 of the dense cached path's largest
   |out| with the same written cache, and bit for bit the same step on the
   cache split by slots; the tokens that agree with the no-mesh run and the
   walls printed, not held.  (c) ``smollm_360m`` at full width and depth
   served over the same mesh with whole weights: its five kv heads do not
   divide 4, so its caches lie by slots; a 1,024-token prefill writing each
   layer's tokens where their slots lie and 16 split-S decode steps within
   2^-5 of the no-mesh decode, the calls counted, each shard's cache bytes
   the reckoning, the walls beside the caches whole in the same process.
   (b) ``smollm_360m`` at full
   width, one step of 8 x 4,096 tokens (remat full) over ``make_mesh(4, 1,
   devices=[cuda:0] * 4)`` and one with microbatch 2 and no mesh from the
   same state, in turns (mesh, microbatch, microbatch, mesh): params,
   moments and loss bit for bit, each repeat bit for bit, 256 forward and
   128 + 128 backward attention launches a step; step ms and peak memory
   printed;
4h. the train state in slices over four data rows emulated on the card
   (``make_mesh(4, 1, devices=[cuda:0] * 4)``; each row keeps its quarter
   of every sliced leaf of the float32 weights and AdamW moments and
   gathers a layer's weights as it runs it).  (a) ``smollm_360m`` at full
   width and depth, one step of 8 x 4,096 tokens (remat full) sliced and one
   replicated from the same seed, in turns (sliced, replicated, replicated,
   sliced): params, moments, loss and grad_norm bit for bit, each repeat bit
   for bit, each row's bytes the placements' reckoning, 256 forward and 128
   + 128 backward attention launches a step.  (b) ``qwen3_8b`` at full width
   cut to 8 of its 36 layers (its whole state is 131 GB; 8 layers: 2.79e9
   parameters, 44.6 GB, 11.15 GB a row): two steps of one 4,096-token
   sequence a row, then the same two again from the same seed (the last
   traced: the step's device time split into the gathers' copies, their
   gradient adds, GEMMs, attention and the rest): the loss finite and
   falling, the repeat bit for bit, each row a quarter of every sliced leaf,
   the peak under 72 GB, 64 forward and 32 + 32 backward launches a step;
4i. the roofline — (a) 4c's step counted on ``meta`` tensors by
   ``repro_torch.launch.dryrun`` (nothing allocated), in parts (outer +
   32 layers + accumulation + AdamW) equal to the whole step counted at
   once, its model flops exactly 6 x 361,820,160 x 32,768; (b) one real
   step of 4c's model on the card under ``launch.roofline.count()``: its
   flops equal to (a)'s, its bytes within 1% (the ops that differ named),
   and the attention launches the kernels made equal to the launches the
   counter charged, every one on the tensor-core kernels; (c) achieved
   TFLOP/s, mfu (model flops over the step at 989 TFLOP/s) and the
   roofline bound's share of each of 4c's warm steps, and of 4h (b)'s
   ``qwen3_8b`` at 8 layers from its dry run over four data rows;
4j. SSD training — ``mamba2_2p7b`` at full width and depth (64 layers,
   2.83e9 parameters, float32 master weights, AdamW) trained through
   ``repro_torch.launch.train.main`` for 4 steps of 1 x 4,096 tokens (remat
   full, bf16 compute, seed 12): finite losses and gradient norms, the peak
   under 80 GB beside its prediction, step ms and tokens/s; a step's
   launches 128 ``ssd_wgmma`` + 128 ``ssd_scan`` forwards and 64 of each
   backward launch, the state and chunk kernels all on the tensor-core
   route; the same step twice from one state equal bit for bit
   (the first state kept on the host), one step profiled (SSD forward and
   backward kernels, GEMMs, the rest, idle share).  The C14 check: the
   model cut to 2 layers at full width, its decays set as Mamba-2
   initialises them, one microbatch of 1 x 4,096 tokens through the kernels
   against the plain SSD's autograd: loss and gradient norm within phase
   4c's limits, every leaf within 2^-6 of its largest |g|, no leaf all
   zeros, and the plain backward that drops the carry D_k g_k over the leaf
   limit; that model's step counted on the card equal to the meta dry run
   (flops; bytes within 1%), each SSD kernel launched as often as charged;
   the full model's count on meta and the warm steps' mfu and bound share;
4k. the five registered models no earlier phase runs — ``musicgen_large``
   (4 codebooks), ``h2o_danube_3_4b`` (D 120, window 4,096),
   ``starcoder2_7b`` (GQA group 9), ``qwen3_moe_30b_a3b`` (128 experts, top
   8) and ``internvl2_76b`` (256 patch embeddings), random weights from a
   seed at full width.  Each depth is reckoned first and printed beside its
   bytes (``reckon_depth``: the deepest within 76 GB, serving at 2 bytes a
   parameter plus 4 GB, training at 16 plus the step's logits, remat inputs,
   a stacked leaf's gradient and 4 GB): served at 48, 24, 32, 48 and 39 of
   80 layers, trained at 48, 24, 16 of 32, 5 of 48 and 2 of 80; run at
   most 24 deep (``REG_MAX_LAYERS``, so that the script keeps its time):
   served at 24, 24, 24, 24, 24, trained at 24, 24, 16, 5, 2.  Served
   behind an OpportunisticServer as in 4d (musicgen's prompts (4, 1,024),
   internvl2 text-only): warm faster in simulated latency, the resubmission
   a cache hit, warm tokens equal to a cold recompute, a fresh server equal
   in tokens and last logits bit for bit, no attention launch; the first 2
   layers decoded over 128 tokens against one cache-free forward (two
   forward kernel launches; an MoE's capacity raised so that the forward
   drops nothing, as decode does not, and each decode step on the experts
   the forward took there, every position held); qwen3-moe's layer-0
   ``moe_ffn`` against float64.
   Trained 4 steps of 1 x 4,096 tokens (remat full, float32 master weights,
   AdamW) through ``launch.train.main`` where the whole model fits, else
   ``make_train_step`` on the cut config with the launcher's optimizer
   (``launcher_opt``; internvl2's batch with its
   ``vis_embeds``): finite losses and norms, 2 forward and 1 + 1 backward
   launches a layer a step, all on the tensor-core kernels; the first step
   again from the same state under ``roofline.count()`` (flops equal to the
   meta dry run's, bytes within 1%, the launches the counter charged), then
   profiled, params, moments and loss equal (every leaf's two 64-bit
   checksums); check 2 at 2 layers (the MoE's as 4f's); mfu and the bound's
   share of each warm step;
4l. tensor parallelism — ``internvl2_76b`` (64 (8) heads, 256 patch
   embeddings) and ``starcoder2_7b`` at full width over ``make_mesh(1, 4,
   devices=[cuda:0] * 4)``, each at the deepest depth where its whole copy
   and its four slices fit 76 GB together (``tp_depth``; 16 of 80 and all 32
   layers): made whole and, from the same seed, straight into its slices
   (each leaf whose placement names the model axis a quarter a shard,
   ``models/tp.py``), each shard's bytes the placements' reckoning, every
   slice equal to the whole draw's quarter; the cache-free forward over the
   shards (4,352 and 4,096 positions) with ``attn_fwd_wgmma`` launched once
   a layer a shard at the shard's heads, its logits within 2^-5 of the
   largest |logit| of the no-mesh forward's, and a TP sum that drops shard
   3's parts over that limit (the control); layer 0 against float64 with
   the whole weights on its first 1,024 positions; a repeat in a fresh mesh
   bit for bit; one forward traced (the ``tp_*`` ranges' device ms: the
   cache-free forward runs its residual stream in sequence slices, so its
   moves are ``tp_seq_gather`` and ``tp_seq_scatter``; the control's sum
   takes the last shard's part as zeros); ``make_serve_fns(mesh)``'s 1,024-token
   prefill and 16 greedy decode steps, each step's logits against the
   no-mesh decode fed the same tokens, walls beside the no-mesh run's;
4m. training over the model shards — four shards emulated on the card:
   ``qwen3_moe_30b_a3b`` at full width and 2 layers, one step of 1 x 4,096
   tokens over ``make_mesh(1, 4)`` (each model-axis leaf in slices, the MoE
   expert-parallel) against the no-mesh step on the same weights (its
   experts replayed from the TP step's routing): the loss, and every
   gradient leaf within 2^-4 of its largest |g| (``TPT_GRAD_TOL``), a TP
   sum that drops shard 3's parts over that limit; every step here runs the
   reference's sequence parallelism (the residual stream in sequence
   slices, counted by the ``tp.all_gather_seq`` calls) and its loss on the
   head's vocabulary slices; for each of the three cuts, the cache-free
   forward's logits under SP against the whole-row path's (bit for bit,
   or within 2^-4 of the largest |logit|, printed), and ``lm_loss_sliced``
   on the logits' four column slices against ``lm_loss`` on them joined
   (``SEQ_LOSS_TOL``), with a control whose sum drops the last shard's
   exponentials (over ``SEQ_LOSS_CONTROL``); an AdamW step of 2 x 4,096
   tokens over ``(2, 2)`` (TP × FSDP) bit for bit the step over ``(1, 2)``
   in microbatches of one sequence, and again from a fresh state (traced:
   the ``tp_*`` ranges' device ms, ``tp_seq_gather`` and ``tp_seq_scatter``
   among them, and ``fsdp_*``'s), each card's bytes the placements'
   reckoning; ``mamba2_2p7b`` at 2 layers and ``recurrentgemma_9b``'s
   first pattern group served over the shards (the SSD / RG-LRU ``in_proj``
   by columns, ``out_proj`` by rows; a 1,024-token prefill and 16 decode
   steps within 2^-5 of the no-mesh model's) and trained (the gradient check
   above, with Mamba-2's decays); mamba2 through ``train_loop`` over ``(2,
   2)`` for 3 steps, and killed at step 2 and resumed: the final
   checkpoint's files byte for byte; every attention and SSD launch of the
   steps on the tensor-core kernels;
5. main-path shapes — each kernel against its plain version, by the rules
   of phase 2 (segment_reduce with all its contracts), at every shape the
   main path (or the serving phase, or phase 3c's sharded run) gave it;
   then the kernel, its plain version and one PyTorch library call timed at
   the largest of them, beside the card's bound (attention: at the training
   shape, against ``scaled_dot_product_attention`` and its backward, with
   the FMA backward kernels on the same bf16 inputs beside the tensor-core
   ones; the SSD's backward at mamba2_2p7b's training launch, each kernel
   through its C entry, the tensor-core state and chunk kernels beside the
   FMA ones on the same buffers, bounds at the bf16 and the float32 peaks;
   the forward and backward also at qwen3_8b's heads, D 128, at
   phase 4e's shape, 16 heads over one kv head of 256, window 2,048 (SDPA
   with the window as a mask), at phase 4f's, 4 x 24 (8) x 4,096 x 64, at
   phase 4h's heads over four sequences, 4 x 32 (8) x 4,096 x 128, and at
   phase 4k's five training shapes, each also held against the plain
   attention (output and the three gradients), the forward at phase
   4l's two shard shapes, 1 x 16 (2) x 4,352 x 128 and 1 x 9 (1) x 4,096 x
   128, and the forward, dQ and dK/dV at TP training's four shard shapes
   (``TPT_ATTN``: 1 x 16 (4), 1 x 16 (2) and 1 x 8 (1) x 4,096 x 128; 1 x 4
   (1) x 4,096 x 256, window 2,048);
   segment_reduce also at B = 100,000 and at B = 1,000 with one sum row;
   join_probe's wrapper beside its bare C entry point, against
   ``torch.searchsorted``; masked_stats, topk and filter_compact each
   beside its bare C entry point, with each of its kernels' device time
   from torch.profiler; topk also on its rows sorted ascending, beside
   ``torch.topk`` on them;
   ssd_chunk_scan's ``ssd_wgmma`` at the 1,024-token prefill's shape and
   ``ssd_short`` at the one-token-chunk prompt's, each beside ``ssd_cells``
   on the same inputs; the inter-chunk scan ``ssd_scan`` at both prompts'
   shapes, its wrapper beside its bare C entry, the plain loop and its
   bound; ``ssd_recur`` at the one-token-chunk prompt's shape, its wrapper
   beside its bare C entry, the pair ``ssd_short`` + ``ssd_scan`` on the
   same inputs, the plain version and its bound; the SSD's three backward
   kernels at mamba2_2p7b's training launch, each through its C entry,
   beside the wrapper, the plain backward and each kernel's bound).

Each kernel's bound comes from ``repro_torch.launch.roofline`` (``bound`` and
the work formulas), the copy the roofline's step count reads.  The last
lines are phase 4i's counts as a JSON object, the card's name and power
limit, a JSON object per kernel, and the result line ``{"ok": true,
"device": {...}}``.  Imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

try:  # the card's peaks and the kernels' work formulas: one copy, in the package
    from repro_torch.launch.roofline import (PEAK_FLOPS as BF16_OPS_PER_S,
                                             PEAK_FLOPS_F32 as F32_OPS_PER_S, attention_work,
                                             bound, recur_work, scan_work, ssd_bwd_total,
                                             ssd_bwd_work, ssd_work)
except ImportError:  # main() says the package is missing
    BF16_OPS_PER_S = F32_OPS_PER_S = None
ROWS = 10_000_000

REPLACES = {
    "masked_stats": "src/repro/kernels/masked_stats.py:84",
    "segment_reduce": "src/repro/kernels/segment_reduce.py:103",
    "topk": "src/repro/kernels/topk.py:56",
    "filter_compact": "src/repro/kernels/filter_compact.py:67",
    "join_probe": "src/repro/kernels/join_probe.py:89",
    # the three routes of one pass: ssd_cells (float32 FMA), ssd_short (short
    # chunks, float32 FMA) and ssd_wgmma (bf16 on the tensor cores)
    "ssd_chunk_scan_cells": "src/repro/kernels/ssd_chunk.py:103",
    "ssd_chunk_scan_short": "src/repro/kernels/ssd_chunk.py:103",
    "ssd_chunk_scan_wgmma": "src/repro/kernels/ssd_chunk.py:103",
    # the inter-chunk scan and correction after that pallas_call (ssd_scan)
    "ssd_chunk_scan_inter": "src/repro/kernels/ssd_chunk.py:128-150",
    # the whole function at one-token chunks: the pallas_call and the scan
    # after it (ssd_recur)
    "ssd_chunk_scan_recur": "src/repro/kernels/ssd_chunk.py:103-150 (at one-token chunks)",
    "flash_attention": "src/repro/kernels/flash_attention.py:133",
    # the bf16 route of the same forward, on the tensor cores
    "flash_attention_wgmma": "src/repro/kernels/flash_attention.py:133",
    # no TPU counterpart: the reference's Pallas call has no backward
    "flash_attention_bwd_dq": "none (no TPU kernel: the reference differentiates "
                              "ref.attention_xla_chunked with XLA)",
    "flash_attention_bwd_dkdv": "none (no TPU kernel: the reference differentiates "
                                "ref.attention_xla_chunked with XLA)",
    # the bf16 route of the same backward, on the tensor cores
    "flash_attention_bwd_dq_wgmma": "none (no TPU kernel: the reference differentiates "
                                    "ref.attention_xla_chunked with XLA)",
    "flash_attention_bwd_dkdv_wgmma": "none (no TPU kernel: the reference differentiates "
                                      "ref.attention_xla_chunked with XLA)",
    # the SSD's backward: no TPU counterpart, the reference differentiates
    # its XLA chunked scan; its state and chunk kernels' bf16 route on the
    # tensor cores beside the float32 FMA ones
    **{name: "none (no TPU kernel: the reference differentiates ref.ssd_xla_chunked with XLA, "
             "src/repro/kernels/ops.py:119-123)"
       for name in ("ssd_chunk_scan_bwd_state", "ssd_chunk_scan_bwd_chunk",
                    "ssd_chunk_scan_bwd_sum", "ssd_chunk_scan_bwd_state_wgmma",
                    "ssd_chunk_scan_bwd_chunk_wgmma")},
}
SOURCES = {name: name for name in REPLACES} | {
    name: "ssd_chunk" for name in REPLACES if name.startswith("ssd_chunk_scan")} | {
    name: "ssd_bwd" for name in REPLACES if name.startswith("ssd_chunk_scan_bwd")} | {
    name: "flash_attention" for name in REPLACES if name.startswith("flash_attention")}
DATAFRAME = ("masked_stats", "segment_reduce", "topk", "filter_compact", "join_probe")
SERVING = ("ssd_chunk_scan_cells", "ssd_chunk_scan_short", "ssd_chunk_scan_wgmma",
           "ssd_chunk_scan_inter", "ssd_chunk_scan_recur")
TRAINING = ("flash_attention", "flash_attention_wgmma", "flash_attention_bwd_dq",
            "flash_attention_bwd_dkdv", "flash_attention_bwd_dq_wgmma",
            "flash_attention_bwd_dkdv_wgmma")
BF16_ULP = 2.0 ** -7  # one bfloat16 ulp, relative


def ptxas_report(log: str, kernels: str = r"attn_[a-z_]+"):
    """[(kernel<template arguments>, registers, spill store bytes, spill load
    bytes)] of the kernels whose names match ``kernels`` (the attention
    kernels by default) in an nvcc ``-Xptxas -v`` log."""
    import re

    out, name, spills = [], None, (0, 0)
    for line in log.splitlines():
        m = re.search(rf"Compiling entry function '\S*?\d+({kernels})I(\S*?)EEv", line)
        if m:
            kind = ("bf16," if "bfloat16" in m.group(2) else
                    "f32," if m.group(2).startswith("f") else "")
            name = f"{m.group(1)}<{kind}{','.join(re.findall(r'Li(\d+)E', m.group(2)))}>"
            spills = (0, 0)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append((name, int(m.group(1))) + spills)
            name = None
    return out


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


# --------------------------------------------------------------------------- #
# phase 2: kernel vs plain version                                             #
# --------------------------------------------------------------------------- #


def check_stats(torch, got, want, xs, ms, label):
    """masked_stats rows: count, min, max exact; sum within 1e-5 of the row's
    Σ|x|; m2 within 1e-4 relative.  Returns max |err| over finite entries."""
    g, w = got.double(), want.double()
    scale = torch.where(ms, xs.abs(), 0.0).double().sum(1) + 1e-30
    check(torch.equal(g[:, [0, 3, 4]], w[:, [0, 3, 4]]), f"masked_stats count/min/max {label}")
    check(bool(((g[:, 1] - w[:, 1]).abs() <= 1e-5 * scale).all()), f"masked_stats sum {label}")
    check(bool(((g[:, 2] - w[:, 2]).abs() <= 1e-4 * w[:, 2].abs() + 1e-6).all()),
          f"masked_stats m2 {label}")
    fin = torch.isfinite(g) & torch.isfinite(w)
    return float((g - w)[fin].abs().max()) if bool(fin.any()) else 0.0


def check_segment(torch, got, want, keys, vals, valid, nbk, modes, vidx, label):
    """segment_reduce: counts, min, max exact; each bucket's sum within 1e-5
    of that bucket's own Σ|x|.  Returns max |err| of the sums."""
    (gr, gc), (wr, wc) = got, want
    check(torch.equal(gc, wc), f"segment_reduce counts {label}")
    err = 0.0
    live = (keys >= 0) & (keys < nbk)
    for s, mode in enumerate(modes):
        if mode != "sum":
            check(torch.equal(gr[s], wr[s]), f"segment_reduce {mode} {label}")
            continue
        scale = torch.zeros(nbk, dtype=torch.float64, device=keys.device).index_add_(
            0, keys[live].long(), torch.where(valid[vidx[s]], vals[s].abs(), 0.0)[live].double())
        e = (gr[s].double() - wr[s].double()).abs()
        check(bool((e <= 1e-5 * scale).all()),
              f"segment_reduce sum {label}: excess {float((e - 1e-5 * scale).max())}")
        err = max(err, float(e.max()))
    return err


def same_values(torch, a, b) -> bool:
    """Equal shapes and values, NaN equal to NaN (== otherwise, so that +0.0
    and -0.0 may trade places)."""
    return a.shape == b.shape and bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


def check_topk(torch, got, want, label):
    """topk values exact (NaN equal to NaN; +0.0 / -0.0 may trade places)."""
    check(same_values(torch, got, want), f"topk {label}")
    return 0.0


def check_compact(torch, got, want, label):
    """filter_compact: the compacted bytes and the counts exact."""
    (g, gc), (w, wc) = got, want
    bits = {8: torch.int64, 4: torch.int32, 1: torch.uint8}[g.element_size()]
    check(torch.equal(g.view(bits), w.view(bits)) and torch.equal(gc, wc),
          f"filter_compact {label}")
    return 0.0


def check_join(torch, got, want, label):
    """join_probe: positions and hits exact."""
    check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), f"join_probe {label}")
    return 0.0


def ssd_ratios(torch, got, want):
    """(max |err| of y, of h_final), each over its limit: y within two ulps
    of its type (bf16: 2^-6; f32: 1e-5 relative) of the call's largest |y|
    (both versions round y_intra and y at the same two places, from float32
    sums taken in another order); h_final (float32) within 1e-5 of its
    largest |h|.  A non-finite y is over its limit."""
    (gy, gh), (wy, wh) = got, want
    rel = 2 * BF16_ULP if wy.dtype == torch.bfloat16 else 1e-5
    ey = float((gy.float() - wy.float()).abs().max())
    if not bool(torch.isfinite(gy.float()).all()):
        ey = math.inf
    return (ey / (rel * float(wy.float().abs().max())),
            float((gh - wh).abs().max()) / (1e-5 * float(wh.abs().max())))


def check_ssd(torch, got, want, label):
    """ssd_chunk_scan within :func:`ssd_ratios`' limits.  Returns max |err|
    of y."""
    (gy, gh), (wy, wh) = got, want
    check(gy.dtype == wy.dtype and gy.shape == wy.shape and gh.shape == wh.shape,
          f"ssd_chunk_scan types / shapes {label}")
    ry, rh = ssd_ratios(torch, got, want)
    check(ry <= 1.0, f"ssd_chunk_scan y {label}: err / limit {ry}")
    check(rh <= 1.0, f"ssd_chunk_scan h {label}: err / limit {rh}")
    return float((gy.float() - wy.float()).abs().max())


def kernel_vs_plain(torch, K, name, args, label):
    """One kernel against its plain version on the same inputs."""
    mod = K[name]
    got = getattr(mod, name)(*args)
    want = getattr(mod, f"{name}_plain")(*args)
    if name == "masked_stats":
        return check_stats(torch, got, want, args[0], args[1], label)
    if name == "segment_reduce":
        keys, vals, valid, nbk, modes, vidx = args
        return check_segment(torch, got, want, keys, vals, valid, nbk, modes, vidx, label)
    if name == "topk":
        return check_topk(torch, got, want, label)
    if name == "join_probe":
        return check_join(torch, got, want, label)
    if name == "ssd_chunk_scan":
        return check_ssd(torch, got, want, label)
    return check_compact(torch, got, want, label)


def parity(torch, K, rng, dev):
    """Hold each kernel against its plain version; returns max |err| per kernel."""
    import numpy as np

    from repro_torch.kernels import ops

    errs = {name: 0.0 for name in DATAFRAME + SERVING}
    ms_k, tk_k, fc_k = K["masked_stats"], K["topk"], K["filter_compact"]

    def t(a, dtype=None):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)

    def note(name, e):
        errs[name] = max(errs[name], e)

    # -- masked_stats: each case against the plain version, padded, row by
    # row at the batch's own addresses, and row by row from fresh copies
    # (other alignments), all bit for bit
    def stats_case(x, m, label):
        xs, ms = t(x), t(m)
        before = ms_k.launches.value
        note("masked_stats", kernel_vs_plain(torch, K, "masked_stats", (xs, ms), label))
        got = ms_k.masked_stats(xs, ms)
        r, n = xs.shape
        pad = torch.zeros((r, n), dtype=torch.float32, device=dev)
        padded = ms_k.masked_stats(torch.cat([xs, pad], 1), torch.cat([ms, pad.bool()], 1))
        check(bits_equal(torch, padded, got), f"masked_stats pad invariance {label}")
        rows = torch.cat([ms_k.masked_stats(xs[i:i + 1], ms[i:i + 1]) for i in range(r)])
        check(bits_equal(torch, rows, got), f"masked_stats batched == per-row {label}")
        copies = torch.cat([ms_k.masked_stats(xs[i:i + 1].clone(), ms[i:i + 1].clone())
                            for i in range(r)])
        check(bits_equal(torch, copies, got), f"masked_stats batched == per-row copy {label}")
        check(ms_k.launches.value - before == 3 + 2 * r,
              f"masked_stats {label}: the wrapper did not launch its kernel every call")
        return got

    for n in (1, 3, 512, 20_000, 16_384 * 3 + 5, 1 << 20):
        x = rng.normal(1e3, 5.0, (4, n)).astype(np.float32)
        x[0, : min(n, 8)] = -0.0
        m = rng.random((4, n)) < 0.8
        m[1] = False  # all-masked row
        stats_case(x, m, f"n={n}")
    # five rows of 16,385: each row's values start at another 16-byte offset
    n = 16_384 + 1
    stats_case(rng.normal(-3.0, 2.0, (5, n)).astype(np.float32), rng.random((5, n)) < 0.5,
               "5 rows of n=16385")
    # one live value a row, in the last tile: at its end, at its start
    n = 16_384 * 3 + 100
    x = rng.normal(7.0, 1.0, (2, n)).astype(np.float32)
    m = np.zeros((2, n), bool)
    m[0, n - 1] = m[1, 16_384 * 3] = True
    got = stats_case(x, m, "one live value in the last tile")
    check(got[:, 0].tolist() == [1.0, 1.0] and got[:, 2].tolist() == [0.0, 0.0],
          "masked_stats: one live value must give count 1 and m2 0")
    # ROADMAP C2: +inf, -inf and NaN in masked lanes contribute nothing
    n = 40_000
    x = rng.normal(0.0, 3.0, (3, n)).astype(np.float32)
    m = rng.random((3, n)) < 0.6
    junk = np.where(rng.random((3, n)) < 0.5, np.inf, -np.inf).astype(np.float32)
    junk[rng.random((3, n)) < 0.3] = np.nan
    x = np.where(m, x, junk)
    got = stats_case(x, m, "inf and NaN in masked lanes")
    check(bool(torch.isfinite(got).all()), "masked_stats: a masked inf or NaN reached the result")
    # a row slice whose pointers are not 16-byte aligned (values 4 bytes and
    # mask 1 byte past an allocation), alone and through the parts batch
    n = 16_384 * 2 + 7
    flat = t(rng.normal(5.0, 2.0, 2 * n + 1).astype(np.float32))
    mflat = t(rng.random(2 * n + 1) < 0.7)
    xs, ms = flat[1:].view(2, n), mflat[1:].view(2, n)
    check(xs.data_ptr() % 16 != 0, "masked_stats: the slice is aligned")
    got = ms_k.masked_stats(xs, ms)
    note("masked_stats", check_stats(torch, got, ms_k.masked_stats_plain(xs, ms), xs, ms,
                                     "unaligned slice"))
    check(bits_equal(torch, got, ms_k.masked_stats(xs.clone(), ms.clone())),
          "masked_stats: unaligned slice != its aligned copy")
    parts = ops.masked_stats_batch_parts([xs[:1], flat[:n].view(1, n), xs[1:]],
                                         [ms[:1], mflat[:n].view(1, n), ms[1:]])
    check(bits_equal(torch, parts[[0, 2]], got),
          "masked_stats_batch_parts of unaligned slices != the slices alone")

    # -- segment_reduce
    segment_parity(torch, K, rng, dev, note)

    # -- topk: each case for largest and smallest, against the plain version,
    # padded with the losing sentinel, and row by row
    def topk_case(xs, k, label):
        for largest in (True, False):
            lab = f"{label} k={k} largest={largest}"
            before = tk_k.launches.value
            note("topk", kernel_vs_plain(torch, K, "topk", (xs, k, largest), lab))
            got = tk_k.topk(xs, k, largest)
            r, n = xs.shape
            sent = float("-inf") if largest else float("inf")
            pad = torch.full((r, n), sent, device=dev)
            check(same_values(torch, tk_k.topk(torch.cat([xs, pad], 1), k, largest), got),
                  f"topk pad invariance {lab}")
            rows = torch.cat([tk_k.topk(xs[i:i + 1], k, largest) for i in range(r)])
            check(same_values(torch, rows, got), f"topk batched == per-row {lab}")
            check(tk_k.launches.value - before == 3 + r,
                  f"topk {lab}: the wrapper did not launch its kernel every call")

    for n, k in ((1, 1), (512, 128), (5000, 20), (1 << 20, 128), (1 << 20, 1)):
        x = rng.normal(0.0, 1.0, (3, n)).astype(np.float32)
        x[0, : min(n, 3)] = [np.inf, -np.inf, -0.0][: min(n, 3)]
        x[1, : min(n, 2)] = 0.0
        topk_case(t(x), min(k, n), f"n={n}")
    n = 300_001  # sorted rows: the running threshold's worst case, and its best
    x = np.sort(rng.normal(0.0, 1.0, (2, n)).astype(np.float32), axis=1)
    x[1] = x[1, ::-1].copy()
    for k in (20, 128):
        topk_case(t(x), k, "ascending and descending rows")
    topk_case(torch.full((1, 100_000), 2.5, device=dev), 20, "one value repeated")
    x = np.full((2, 50_000), -np.inf, np.float32)  # 7 finite values a row
    x[:, rng.choice(50_000, 7, replace=False)] = rng.normal(0.0, 1.0, (2, 7))
    topk_case(t(x), 20, "fewer than k finite values")
    topk_case(t(rng.normal(0.0, 1.0, (2, 129)).astype(np.float32)), 128, "n=129")
    topk_case(t(rng.normal(0.0, 1.0, (3, 4097)).astype(np.float32)), 20, "3 rows of n=4097")
    n = 70_001  # rows that start 4 bytes past a 16-byte boundary
    flat = t(rng.normal(0.0, 1.0, 2 * n + 1).astype(np.float32))
    xs = flat[1:].view(2, n)
    check(xs.data_ptr() % 16 != 0, "topk: the slice is aligned")
    topk_case(xs, 20, "unaligned slice")
    # NaN ranks above every value, for largest either way (the reference's
    # rounds of max / argmax): the smallest row, then one NaN, more NaNs than
    # k, and NaNs beside +inf and -inf, on one launch and on two
    topk_case(t(np.array([[1.0, np.nan, 3.0, 2.0, -1.0]], np.float32)), 2, "NaN, smallest row")
    for n, k in ((5000, 20), (300_001, 20), (1 << 20, 128), (129, 128)):
        x = rng.normal(0.0, 1.0, (3, n)).astype(np.float32)
        x[0, rng.integers(n)] = np.nan
        x[1, rng.choice(n, k + 1, replace=False)] = np.nan
        x[2, rng.choice(n, 6, replace=False)] = [np.nan, np.inf, -np.inf, np.nan, np.inf, -np.inf]
        topk_case(t(x), k, f"NaN rows n={n}")

    # -- filter_compact: every element width, shared and per-row masks, at
    # each tile edge (odd n: the second per-row mask starts off a 16-byte
    # boundary, so its counts take single bytes) and past 2,048 tiles
    from repro_torch.kernels import _build

    ft = fc_k.FC_TILE
    check(_build.load("filter_compact").repro_filter_compact_tile() == ft,
          "filter_compact: FC_TILE is not the kernel's tile")
    for n in (1, ft - 1, ft, ft + 1, 4097, 1 << 20, 4_500_001):
        for dtype in (torch.float64, torch.int64, torch.int32, torch.float32, torch.bool):
            base = rng.normal(0.0, 1e6, (2, n))
            x = t(base).to(dtype)
            bits = {8: torch.int64, 4: torch.int32, 1: torch.uint8}[x.element_size()]
            for kind in ("empty", "full", "random"):
                keep = {"empty": np.zeros(n, bool), "full": np.ones(n, bool),
                        "random": rng.random(n) < 0.5}[kind]
                note("filter_compact", kernel_vs_plain(
                    torch, K, "filter_compact", (x, t(keep), 0), f"{dtype} n={n} keep={kind}"))
                per = {"empty": np.zeros((2, n), bool), "full": np.ones((2, n), bool),
                       "random": rng.random((2, n)) < 0.3}[kind]
                note("filter_compact", kernel_vs_plain(
                    torch, K, "filter_compact", (x, t(per), 0),
                    f"{dtype} n={n} per-row keep={kind}"))
                g2, c2 = fc_k.filter_compact(x, t(per), 0)
                r0, c0 = fc_k.filter_compact(x[:1].contiguous(), t(per[0]), 0)
                check(torch.equal(g2[:1].view(bits), r0.view(bits)) and int(c2[0]) == int(c0[0]),
                      f"filter_compact batched == per-row {dtype} n={n} keep={kind}")

    # -- join_probe
    join_parity(torch, K, rng, dev, note)

    # -- ssd_chunk_scan
    ssd_parity(torch, K, rng, dev, note)
    return errs


def bits_equal(torch, a, b) -> bool:
    """Equal bit for bit (so +0.0 and -0.0 differ, and NaN equals itself)."""
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and torch.equal(a, b)


def zipf_keys(rng, n, nbk, a=1.1):
    """n keys over nbk buckets with Zipf(a) frequencies, the heavy buckets
    scattered over the key range."""
    import numpy as np

    p = 1.0 / np.arange(1, nbk + 1, dtype=np.float64) ** a
    return rng.permutation(nbk).astype(np.int32)[rng.choice(nbk, n, p=p / p.sum())]


def segment_contracts(torch, K, rng, dev, args, label):
    """segment_reduce against its plain version, then its bit-for-bit
    contracts: batched == per-row, pad invariance (key 0, valid False),
    two calls equal, and bucket independence (rows of other keys, in range
    and out of it, inserted between the rows change no other bucket).
    Returns max |err| of the sums."""
    import numpy as np

    sr = K["segment_reduce"]
    keys, vals, valid, nbk, modes, vidx = args
    n, S, V = keys.shape[0], vals.shape[0], valid.shape[0]
    err = kernel_vs_plain(torch, K, "segment_reduce", args, label)
    gr, gc = sr.segment_reduce(*args)
    again = sr.segment_reduce(*args)
    check(bits_equal(torch, again[0], gr) and bits_equal(torch, again[1], gc),
          f"segment_reduce two calls differ {label}")
    for s, (mode, v) in enumerate(zip(modes, vidx)):
        rr, rc = sr.segment_reduce(keys, vals[s:s + 1], valid[v:v + 1], nbk, [mode], [0])
        check(bits_equal(torch, rr[0], gr[s]) and bits_equal(torch, rc[0], gc[v]),
              f"segment_reduce batched == per-row {label} row {s}")
    pad = n + 5000
    kp = torch.cat([keys, torch.zeros(pad, dtype=torch.int32, device=dev)])
    vp = torch.cat([vals, torch.ones((S, pad), device=dev)], 1)
    mp = torch.cat([valid, torch.zeros((V, pad), dtype=torch.bool, device=dev)], 1)
    pr, pc = sr.segment_reduce(kp, vp, mp, nbk, modes, vidx)
    check(bits_equal(torch, pr, gr) and bits_equal(torch, pc, gc),
          f"segment_reduce pad invariance {label}")
    # bucket independence: extra rows of three in-range keys and of keys out
    # of range, at random places among the rows
    extra = max(1, n // 4)
    others = rng.choice(nbk, min(3, nbk - 1), replace=False).astype(np.int64)
    pool = np.concatenate([others, [-1, nbk, 2 ** 31 - 1]]).astype(np.int64)
    ek = pool[rng.integers(0, len(pool), extra)]
    at = np.sort(rng.integers(0, n + 1, extra))
    order = np.argsort(np.concatenate([np.arange(n) * 2 + 1, at * 2]), kind="stable")
    idx = torch.as_tensor(order, device=dev)
    ki = torch.cat([keys, torch.as_tensor(ek.astype(np.int32), device=dev)])[idx].contiguous()
    vi = torch.cat([vals, torch.as_tensor(rng.normal(0, 1e3, (S, extra)).astype(np.float32),
                                          device=dev)], 1)[:, idx].contiguous()
    mi = torch.cat([valid, torch.as_tensor(rng.random((V, extra)) < 0.9, device=dev)],
                   1)[:, idx].contiguous()
    ir, ic = sr.segment_reduce(ki, vi, mi, nbk, modes, vidx)
    keep = torch.ones(nbk, dtype=torch.bool, device=dev)
    keep[torch.as_tensor(others, device=dev)] = False
    check(bits_equal(torch, ir[:, keep], gr[:, keep]) and bits_equal(torch, ic[:, keep], gc[:, keep]),
          f"segment_reduce bucket independence {label}")
    return err


# segment_reduce's edge shapes, (n, B, kind): uniform keys at every width of
# the old tiling (the last two beyond one block's shared memory), then one
# bucket holding every row (the longest run, the deepest fold), Zipf keys at
# cell 7's size, a call with no valid row, keys out of range mixed in, and
# the widest B at the widest main-path row count.
SEGMENT_SHAPES = ((1, 1, "uniform"), (2048, 64, "uniform"), (100_003, 1000, "uniform"),
                  (1 << 20, 64, "uniform"), (300_001, 100_000, "uniform"),
                  (5000, (1 << 24) - 1, "uniform"), (1 << 21, 1, "uniform"),
                  (2_204_249, 100_000, "zipf"), (100_003, 1000, "none valid"),
                  (100_003, 1000, "out of range"), (300_001, (1 << 24) - 1, "uniform"))


def segment_parity(torch, K, rng, dev, note):
    import numpy as np

    for n, nbk, kind in SEGMENT_SHAPES:
        keys = zipf_keys(rng, n, nbk) if kind == "zipf" else rng.integers(0, nbk, n).astype(np.int32)
        if kind == "out of range":
            bad = rng.random(n) < 0.1
            keys[bad] = rng.choice(np.array([-1, nbk, 2 ** 31 - 1], np.int32), int(bad.sum()))
        valid = rng.random((2, n)) < (0.0 if kind == "none valid" else 0.9)
        args = (torch.as_tensor(keys, device=dev),
                torch.as_tensor(rng.normal(0.0, 10.0, (3, n)).astype(np.float32), device=dev),
                torch.as_tensor(valid, device=dev), nbk, ["sum", "min", "max"], [0, 1, 1])
        note("segment_reduce", segment_contracts(torch, K, rng, dev, args,
                                                 f"n={n} B={nbk} {kind}"))


# join_probe's right sides beyond the sample rule, (m, log_s, kind): the
# sample step forced so that small sides reach its edges: fewer keys than one
# step, a count that is not a multiple of the step, a NaN tail that starts
# inside one step and runs past the next sample point, and left keys equal
# to the sampled keys (and their neighbours).
JOIN_SAMPLE_EDGES = ((3, 3, "m < s"), (1001, 4, "m % s != 0"),
                     (100, 4, "NaN tail over a sample point"),
                     (4099, 5, "keys at sample points"), (70_001, 9, "deep device levels"))


def join_parity(torch, K, rng, dev, note):
    """join_probe against its plain version, exact: every key type; right
    sides staged whole and sampled by the wrapper's rule; then the sample's
    edges with the step forced (JOIN_SAMPLE_EDGES)."""
    import numpy as np

    jp = K["join_probe"]

    def t(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev).to(dtype)

    def forced(lk, r, log_s):
        """the kernel through its C entry point with the sample step 2^log_s"""
        n, m, size = lk.shape[0], r.shape[0], lk.element_size()
        scratch = torch.empty(-(-m >> log_s) * size, dtype=torch.uint8, device=dev)
        pos = torch.empty(n, dtype=torch.int32, device=dev)
        hit = torch.empty(n, dtype=torch.bool, device=dev)
        err = jp._fns()(lk.data_ptr(), n, r.data_ptr(), m, jp.DTYPES[lk.dtype], log_s,
                           scratch.data_ptr(), scratch.numel(), pos.data_ptr(), hit.data_ptr(),
                           torch.cuda.current_stream().cuda_stream)
        check(err == 0, f"join_probe with log_s {log_s} failed with cudaError_t {err}")
        return pos, hit

    def against_plain(lk, r, label, log_s=None):
        got = jp.join_probe(lk, r) if log_s is None else forced(lk, r, log_s)
        note("join_probe", check_join(torch, got, jp.join_probe_plain(lk, r), label))

    for dtype in (torch.float64, torch.float32, torch.int64, torch.int32):
        for n, m in ((1, 1), (5000, 7), (100_000, 1000), (1 << 20, 30_000), (1 << 20, 900_000)):
            r = np.sort(rng.choice(4 * m, m, replace=False)).astype(np.float64) - m
            lk = rng.integers(-2 * m, 4 * m, n).astype(np.float64)
            lk[: min(n, 3)] = r[: min(n, 3)]  # duplicate left keys, exact hits
            if dtype.is_floating_point:
                r = np.concatenate([[-np.inf], r, [np.inf, np.nan]])
                edge = [np.nan, np.inf, -np.inf, -0.0, 0.0]
                lk[: min(n, 5)] = edge[: min(n, 5)]
            against_plain(t(lk, dtype), t(r, dtype), f"{dtype} n={n} m={m}")
        for m, log_s, kind in JOIN_SAMPLE_EDGES:
            r = np.sort(rng.choice(4 * m, m, replace=False)).astype(np.float64) - m
            s = 1 << log_s
            if kind.startswith("NaN") and dtype.is_floating_point:
                r[s * 3 + s // 2:] = np.nan  # from mid-step 3 past sample point 4
            live = r[~np.isnan(r)]
            lk = np.concatenate([r[::s], r[::s] + 1, r[::s] - 1, live[-1:] + 1, live[:1] - 1,
                                 rng.integers(-2 * m, 4 * m, 3000).astype(np.float64)])
            if dtype.is_floating_point:
                lk[:4] = [np.nan, np.inf, -np.inf, -0.0]
            for k in (log_s, log_s + 1):  # 2^k >= 8 keys: a whole sector at either width
                against_plain(t(lk, dtype), t(r, dtype), f"{dtype} m={m} log_s={k} {kind}", k)


# ssd_chunk_scan's shapes, (batch, S, H, P, N, L, dtype): full width; f32;
# one-token chunks; the smoke width; odd dims; then the edges of the
# tensor-core route: L 64 in batches of 2, P 128, N 64, all three at once,
# P 16 (columns zero-filled past P), and 7 heads in blocks of 2 (the last
# block of one head: 26 chunks on 132 SMs give heads_per_block 2); then the
# edges of the short route: f32 at L 1; L 2 and 16 (the threshold, in f32
# and bf16); P 24 and 40; N 17 with P 7 (N P and P no multiple of 4: state
# rows cross float4s); batches of 2; 10 heads in groups of 3 (700 chunks:
# short_heads 3, the last group of one head); L 17, just past the
# threshold, on ssd_cells; and at one-token chunks (ssd_recur) N 256, its
# register limit, N 17 with P 7 in bf16 in batches of 2 over 3 heads, and
# one token.
SSD_SHAPES = ((1, 256, 80, 64, 128, 128, "bfloat16"), (2, 256, 8, 64, 128, 128, "float32"),
              (1, 37, 4, 16, 16, 1, "bfloat16"), (2, 96, 8, 16, 16, 32, "bfloat16"),
              (1, 128, 3, 24, 40, 64, "float32"), (2, 256, 8, 64, 128, 64, "bfloat16"),
              (1, 256, 6, 128, 128, 128, "bfloat16"), (1, 256, 8, 64, 64, 128, "bfloat16"),
              (2, 128, 5, 128, 64, 64, "bfloat16"), (1, 128, 4, 16, 64, 64, "bfloat16"),
              (2, 1664, 7, 64, 128, 128, "bfloat16"),
              (1, 37, 4, 16, 16, 1, "float32"), (2, 64, 5, 24, 128, 2, "bfloat16"),
              (1, 256, 6, 40, 64, 16, "float32"), (1, 96, 3, 40, 128, 16, "bfloat16"),
              (2, 50, 3, 7, 17, 1, "float32"), (1, 64, 5, 7, 17, 16, "bfloat16"),
              (2, 350, 10, 24, 64, 1, "bfloat16"), (1, 68, 4, 64, 128, 17, "float32"),
              (1, 40, 3, 64, 256, 1, "bfloat16"), (2, 30, 3, 7, 17, 1, "bfloat16"),
              (1, 1, 3, 64, 128, 1, "float32"))


def ssd_parity(torch, K, rng, dev, note, shapes=SSD_SHAPES):
    """ssd_chunk_scan against its plain version (check_ssd) at ``shapes``: a
    call that ``scan_route`` sends to ``ssd_recur`` must launch it once and
    no other kernel, with h_final bit for bit; any other must launch the
    kernel ``ssd_route`` names and the scan kernel once each.  Its error is
    noted under the kernel's name.  Then the intra-chunk kernel alone
    (``ssd_chunk_intra``; at one-token chunks its states must equal the
    plain version's bit for bit, each being the one rounding of b_n x_p) and
    the inter-chunk scan kernel alone on its outputs (``ssd_chunk_inter``,
    one launch) against the plain inter-chunk pass: h_final bit for bit, y
    within check_ssd's limits; at one-token chunks the pair's y and h also
    against the plain function, noted under the intra-chunk kernel."""
    sc = K["ssd_chunk_scan"]
    counters = {"cells": sc.launches_cells, "short": sc.launches_short,
                "wgmma": sc.launches_wgmma, "scan": sc.launches_scan,
                "recur": sc.launches_recur}
    for bt, S, H, Pd, N, L, dtype in shapes:
        label = f"{(bt, S, H, Pd, N, L, dtype)}"
        dt = getattr(torch, dtype)
        intra = sc.ssd_route(dt, L, N, Pd)
        recur = sc.scan_route(L, N) == "recur"
        args = ssd_inputs(torch, rng, dev, bt, S, H, Pd, N, dt) + (L,)
        want = sc.ssd_chunk_scan_plain(*args)
        before = {r: c.value for r, c in counters.items()}
        got = sc.ssd_chunk_scan(*args)
        took = {r: c.value - before[r] for r, c in counters.items()}
        check(took == {r: int(r in (("recur",) if recur else (intra, "scan"))) for r in counters},
              f"ssd_chunk_scan {label} launched {took}, not "
              f"{'ssd_recur once' if recur else f'the {intra} kernel and the scan kernel once each'}")
        err = check_ssd(torch, got, want, label)
        if recur:
            check(torch.equal(got[1], want[1]),
                  f"ssd_recur {label}: h_final differs from the plain version's bit for bit")
        note(f"ssd_chunk_scan_{'recur' if recur else intra}", err)
        before = {r: c.value for r, c in counters.items()}
        y_intra, state = sc.ssd_chunk_intra(*args)
        if L == 1:
            check(torch.equal(state, sc.ssd_chunk_intra_plain(*args)[1]),
                  f"ssd_chunk_scan {label}: one-token chunk states differ from the plain "
                  f"version's")
        _, log_a, _, cm, _ = args
        pair = sc.ssd_chunk_inter(y_intra, state, log_a, cm)
        took = {r: c.value - before[r] for r, c in counters.items()}
        check(took == {r: int(r in (intra, "scan")) for r in counters},
              f"ssd_chunk_intra + ssd_chunk_inter {label} launched {took}, not the {intra} "
              f"kernel and the scan kernel once each")
        inter = sc.ssd_chunk_inter_plain(y_intra, state, log_a, cm)
        check(torch.equal(pair[1], inter[1]),
              f"ssd_chunk_inter {label}: h_final differs from the plain version's bit for bit")
        note("ssd_chunk_scan_inter", check_ssd(torch, pair, inter, f"inter-chunk scan {label}"))
        if recur:
            note(f"ssd_chunk_scan_{intra}",
                 check_ssd(torch, pair, want, f"{intra} + inter-chunk scan {label}"))


def ssd_inputs(torch, rng, dev, bt, S, H, Pd, N, dtype):
    """x, log_a, b, c of one SSD call, in the ranges the model gives them
    (log decays in (-0.5, 0))."""
    import numpy as np

    def t(a, dt=dtype):
        return torch.as_tensor(a, device=dev).to(dt).contiguous()

    return (t(rng.normal(0, 1, (bt, S, H, Pd))),
            t(-rng.uniform(1e-3, 0.5, (bt, S, H)), torch.float32),
            t(rng.normal(0, 0.3, (bt, S, N))), t(rng.normal(0, 0.3, (bt, S, N))))


def fused_parity(torch, ops, rng, dev):
    """Fused filter→reduce == compact-then-reduce, bit for bit, on the card."""
    import numpy as np

    n = 300_001
    xs = torch.as_tensor(rng.normal(0, 1, (3, n)).astype(np.float32), device=dev)
    ms = torch.as_tensor(rng.random((3, n)) < 0.9, device=dev)
    keep = torch.as_tensor(rng.random(n) < 0.4, device=dev)
    cnt = int(keep.sum())
    with ops.local_backend("cuda"):
        fused = ops.filter_then_masked_stats(xs, ms, keep)
        xc = torch.stack([ops.filter_compact_padded(xs[i], keep)[0][:cnt] for i in range(3)])
        mc = torch.stack([ops.filter_compact_padded(ms[i], keep, False)[0][:cnt] for i in range(3)])
        unfused = ops.masked_stats_batch(xc, mc)
        check(torch.equal(fused, unfused), "fused filter→stats == unfused")
        keys = torch.as_tensor(rng.integers(0, 64, n).astype(np.int32), device=dev)
        fr, fc = ops.filter_then_segment_reduce(keys, [xs[0], xs[1]], [ms[0], ms[1]], keep,
                                                64, ["sum", "max"], [0, 1])
        kc = ops.filter_compact_padded(keys, keep)[0][:cnt]
        ur, uc = ops.segment_reduce_batch(kc, [xc[0], xc[1]], [mc[0], mc[1]], 64,
                                          ["sum", "max"], [0, 1])
        check(torch.equal(fr, ur) and torch.equal(fc, uc), "fused filter→groupby == unfused")


# --------------------------------------------------------------------------- #
# phase 2b: attention, forward and backward, kernel vs plain                   #
# --------------------------------------------------------------------------- #

# (B, Hq, Hkv, Sq, Skv, D, dtype, causal, window, q_offset): GQA groups 1, 3
# and 8; D 64, 120 and 128; both types; causal and not; windows 32 and 4,096;
# q_offset > 0 with Sq < Skv (alone and with a window, so that a row's first
# kv tiles are all hidden); one 64-row tile; a 96-row sequence (ragged tiles);
# B from 1 to 4; and the training shape's heads.  The last three rows reach
# the tensor-core kernel's edges: D 128 without a mask in groups of 4; D 120
# (two swizzle atoms, the second zero-filled past column 120) with danube's
# heads over 4,096 keys and a window of 4,096; and one 128-row q tile with
# only 64 live rows (Sq 64 < Skv 384, q_offset 320), whose rows past Sq read
# zeros and are never written.
ATTN_SHAPES = (
    (1, 2, 2, 128, 128, 64, "bfloat16", True, None, 0),
    (2, 6, 2, 256, 256, 64, "float32", True, None, 0),
    (4, 8, 1, 128, 128, 128, "bfloat16", True, None, 0),
    (1, 8, 1, 256, 256, 128, "float32", False, None, 0),
    (2, 3, 1, 256, 256, 64, "bfloat16", True, 32, 0),
    (1, 15, 5, 512, 512, 64, "bfloat16", True, 4096, 0),
    (2, 4, 2, 128, 384, 64, "float32", True, None, 256),
    (1, 4, 2, 128, 384, 64, "bfloat16", True, 32, 256),
    (3, 3, 3, 64, 64, 64, "float32", True, None, 0),
    (1, 6, 2, 96, 96, 120, "bfloat16", False, 32, 0),
    (2, 15, 5, 1024, 1024, 64, "bfloat16", True, None, 0),
    (2, 8, 2, 256, 256, 128, "bfloat16", False, None, 0),
    (1, 32, 8, 4096, 4096, 120, "bfloat16", True, 4096, 0),
    (1, 4, 2, 64, 384, 64, "bfloat16", True, None, 320),
) + (
    # head dim 256 (RecurrentGemma's local attention; DP 256: four swizzle
    # atoms, the backward's column halves, the FMA backward's 32-key tiles):
    # MQA group 16 with a window of 2,048 over 4,096 keys in both types; a
    # window of 32 in batches of 2; not causal; q_offset > 0 with Sq < Skv;
    # D 192 (the fourth atom zero-filled); a ragged 96-row sequence
    (1, 16, 1, 4096, 4096, 256, "bfloat16", True, 2048, 0),
    (1, 16, 1, 4096, 4096, 256, "float32", True, 2048, 0),
    (2, 16, 1, 256, 256, 256, "bfloat16", True, 32, 0),
    (2, 16, 1, 256, 256, 256, "float32", True, 32, 0),
    (1, 4, 2, 256, 256, 256, "bfloat16", False, None, 0),
    (2, 16, 1, 128, 384, 256, "bfloat16", True, 32, 256),
    (1, 4, 1, 128, 384, 256, "float32", True, None, 256),
    (1, 4, 2, 128, 128, 192, "bfloat16", True, None, 0),
    (1, 2, 1, 96, 96, 256, "bfloat16", True, None, 0),
)
# Limits, relative to the largest |value| of the plain version's tensor: the
# kernel and the plain version sum in float32 in another order and round to
# the inputs' type once, so a bf16 value may differ by one bf16 ulp of
# itself, and a float32 value by float32 rounding over S-long sums.  The
# tensor-core forward also rounds P to bf16 before P·V; a CPU emulation of
# that rounding stays within the bf16 limit (tests/test_torch_attention.py).
ATTN_TOL = {"bfloat16": 2 * BF16_ULP, "float32": 1e-5}


def attn_inputs(torch, rng, dev, B, Hq, Hkv, Sq, Skv, D, dtype):
    """q, k, v and an output cotangent, N(0, 1) (q and k scaled so that the
    logits spread over several units, as in a trained model)."""
    dt = getattr(torch, dtype)

    def t(shape, sd=1.0):
        return torch.as_tensor(rng.normal(0, sd, shape), device=dev).to(dt).contiguous()

    return (t((B, Hq, Sq, D), 1.5), t((B, Hkv, Skv, D), 1.5), t((B, Hkv, Skv, D)),
            t((B, Hq, Sq, D)))


def attn_grads(torch, fn, q, k, v, g, mask):
    """→ (o, dq, dk, dv) of ``fn`` with the cotangent ``g``."""
    q, k, v = (x.detach().requires_grad_(True) for x in (q, k, v))
    o = fn(q, k, v, *mask)
    dq, dk, dv = torch.autograd.grad(o, (q, k, v), g)
    return o.detach(), dq, dk, dv


def attn_controls(torch, fa):
    """Faulty plain attentions that the limits must catch, by name, with the
    tensor each must spoil."""
    plain = fa.flash_attention_plain

    def no_alpha(q, k, v, causal, window, scale, q_offset):
        # online softmax over 64-key blocks that never rescales what it has
        # summed when the running max grows
        B, Hq, Sq, D = q.shape
        group = Hq // k.shape[1]
        scale = scale if scale is not None else D ** -0.5
        kf = k.float().repeat_interleave(group, 1)
        vf = v.float().repeat_interleave(group, 1)
        s = torch.einsum("bhqd,bhkd->bhqk", q.float() * scale, kf)
        s = s.masked_fill(~fa._mask(Sq, k.shape[2], causal, window, q_offset, q.device),
                          float("-inf"))
        m = torch.full(s.shape[:3] + (1,), float("-inf"), device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros(q.shape, device=q.device)
        for j in range(0, s.shape[-1], 64):
            blk = s[..., j:j + 64]
            m = torch.maximum(m, blk.amax(-1, keepdim=True))
            p = torch.exp(blk - m).nan_to_num(0.0)
            l = l + p.sum(-1, keepdim=True)
            acc = acc + p @ vf[:, :, j:j + 64]
        return (acc / l.clamp_min(1e-30)).to(q.dtype)

    def dkdv_skips_a_head(q, k, v, causal, window, scale, q_offset):
        # the plain attention with the kv gradient of each group's last
        # q-head dropped
        group = q.shape[1] // k.shape[1]
        return _SkipHead.apply(q, k, v, (causal, window, scale, q_offset), group)

    class _SkipHead(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, mask, group):
            ctx.save_for_backward(q, k, v)
            ctx.mask, ctx.group = mask, group
            return plain(q, k, v, *mask)

        @staticmethod
        def backward(ctx, g):
            q, k, v = ctx.saved_tensors
            with torch.enable_grad():
                qq = q.detach().requires_grad_(True)
                kr = k.detach().repeat_interleave(ctx.group, 1).requires_grad_(True)
                vr = v.detach().repeat_interleave(ctx.group, 1).requires_grad_(True)
                o = plain(qq, kr, vr, *ctx.mask)
                dq, dkr, dvr = torch.autograd.grad(o, (qq, kr, vr), g)
            B, Hq, Skv, D = dkr.shape
            shape = (B, Hq // ctx.group, ctx.group, Skv, D)
            keep = torch.ones(ctx.group, device=q.device)
            keep[-1] = 0.0
            dk = (dkr.float().reshape(shape) * keep[:, None, None]).sum(2).to(k.dtype)
            dv = (dvr.float().reshape(shape) * keep[:, None, None]).sum(2).to(v.dtype)
            return dq, dk, dv, None, None

    return {"forward without the alpha rescale": (no_alpha, "o"),
            "dK/dV that skips one head of each group": (dkdv_skips_a_head, "dk")}


def attn_errs(got, want):
    """max |err| and the plain tensor's max |value|, for o, dq, dk, dv."""
    return {name: (float((g.float() - w.float()).abs().max()), float(w.float().abs().max()))
            for name, g, w in zip(("o", "dq", "dk", "dv"), got, want)}


def attention_parity(torch, rng, dev, shapes=ATTN_SHAPES, label="edge"):
    """The kernels (through their autograd Function) against the plain
    version at ``shapes``: each forward on the kernel ``forward_route``
    names and each backward on those ``backward_route`` names, the output
    and the three gradients within ATTN_TOL, two backward
    runs equal bit for bit, and each faulty control over the limit at one
    shape at least.  Returns the max |err| per kernel."""
    from repro_torch.kernels import flash_attention as fa

    errs = {name: 0.0 for name in TRAINING}
    rows = {"o": "flash_attention", "dq": "flash_attention_bwd_dq",
            "dk": "flash_attention_bwd_dkdv", "dv": "flash_attention_bwd_dkdv"}
    tc_rows = {"o": "flash_attention_wgmma", "dq": "flash_attention_bwd_dq_wgmma",
               "dk": "flash_attention_bwd_dkdv_wgmma", "dv": "flash_attention_bwd_dkdv_wgmma"}
    controls = attn_controls(torch, fa)
    caught = {label: 0.0 for label in controls}
    worst = {}
    for B, Hq, Hkv, Sq, Skv, D, dtype, causal, window, off in shapes:
        where = f"{(B, Hq, Hkv, Sq, Skv, D, dtype, causal, window, off)}"
        q, k, v, g = attn_inputs(torch, rng, dev, B, Hq, Hkv, Sq, Skv, D, dtype)
        mask = (causal, window, None, off)
        route = {"o": fa.forward_route(q.dtype, D)}
        route["dq"] = route["dk"] = route["dv"] = fa.backward_route(q.dtype, D)
        counters = {"o": fa.launches_wgmma, "dq": fa.launches_dq_wgmma,
                    "dk": fa.launches_dkdv_wgmma}
        before = {name: c.value for name, c in counters.items()}
        got = attn_grads(torch, fa.flash_attention, q, k, v, g, mask)
        again = attn_grads(torch, fa.flash_attention, q, k, v, g, mask)
        for name, c in counters.items():
            check(c.value - before[name] == (2 if route[name] == "wgmma" else 0),
                  f"attention {name} {where} did not take the {route[name]} kernel")
        want = attn_grads(torch, fa.flash_attention_plain, q, k, v, g, mask)
        for name, a, b in zip(("o", "dq", "dk", "dv"), got, again):
            check(torch.equal(a, b), f"attention {name} differs between two runs {where}")
        tol = ATTN_TOL[dtype]
        for name, (e, scale) in attn_errs(got, want).items():
            check(got[0].dtype == q.dtype, f"attention output type {where}")
            check(e <= tol * scale and e == e,
                  f"attention {name} {where}: max |err| {e} over the limit {tol * scale}")
            errs[rows[name]] = max(errs[rows[name]], e)
            if route[name] == "wgmma":
                errs[tc_rows[name]] = max(errs[tc_rows[name]], e)
            key = f"{name} {dtype}"
            worst[key] = max(worst.get(key, 0.0), e / max(scale, 1e-30))
        for clabel, (faulty, name) in controls.items():
            bad = attn_grads(torch, faulty, q, k, v, g, mask)
            e = attn_errs(got, bad)[name][0]
            caught[clabel] = max(caught[clabel], e / (tol * attn_errs(got, want)[name][1]))
    for clabel, ratio in caught.items():
        check(ratio > 1.0, f"attention control, {clabel}: max |err| is {ratio} of the limit at "
              "every shape, which cannot see it")
    print(f"[parity] attention: kernel vs plain at {len(shapes)} {label} shapes; worst "
          "|err| / max |plain| per tensor and type (limits " + json.dumps(ATTN_TOL) + "): "
          + json.dumps(worst) + "; two backward runs equal "
          "bit for bit; controls, worst |err| over the limit: " + json.dumps(caught), flush=True)
    return errs


def attention_in_new_thread(torch, rng, dev):
    """A forward and backward started in a thread that has made no CUDA call
    yet, as autograd's backward thread may not have: the tensor-core
    kernels' map encoder needs the device's context bound in the calling
    thread.  Equal bit for bit to the same call in this thread."""
    import threading

    from repro_torch.kernels import flash_attention as fa

    q, k, v, g = attn_inputs(torch, rng, dev, 1, 2, 2, 128, 128, 64, "bfloat16")
    mask = (True, None, None, 0)
    out = {}

    def run():
        try:
            out["got"] = attn_grads(torch, fa.flash_attention, q, k, v, g, mask)
        except Exception as exc:  # reported below, in this thread
            out["err"] = exc

    th = threading.Thread(target=run)
    th.start()
    th.join()
    check("err" not in out, f"attention in a new thread raised: {out.get('err')}")
    here = attn_grads(torch, fa.flash_attention, q, k, v, g, mask)
    check(all(torch.equal(a, b) for a, b in zip(out["got"], here)),
          "attention in a new thread differs from the same call in this one")
    print("[parity] attention: a forward and backward in a new thread equal the same call "
          "here bit for bit", flush=True)


# --------------------------------------------------------------------------- #
# phase 2c: the SSD's backward, kernels vs plain                               #
# --------------------------------------------------------------------------- #

SSD_BWD = ("ssd_chunk_scan_bwd_state", "ssd_chunk_scan_bwd_chunk", "ssd_chunk_scan_bwd_sum")
# the rows of the kernels line, one a kernel and each with its own counter:
# the FMA kernels ("cells" route) and ssd_bwd_sum, then the tensor-core
# route's state and chunk kernels
SSD_BWD_WGMMA = ("ssd_chunk_scan_bwd_state_wgmma", "ssd_chunk_scan_bwd_chunk_wgmma")
SSD_BWD_ROWS = SSD_BWD + SSD_BWD_WGMMA
# (batch, S, H, P, N, L, dtype, dh given, slow decays): mamba2_2p7b's training
# launch (1 x 4,096 x 80 x 64, N 128, chunk 128, bf16; no dh, as in the
# model), and the same with dh and slow decays; float32 in batches of 2; L
# 64; the chunk-1 rule at S 40; one chunk of 96 (S < 128); N 17 with P 7 at
# chunks of 16 and of 1; 7 heads at N 256 and P 128, the kernels' limits;
# then the tensor-core route's other instantiations and a partial head
# group: 1,152 tokens at 80 heads (6 heads a chunk block, the last block 2),
# N 64 with P 128, and P 72 at chunks of 64 (2 heads a block of 7, the last
# block 1).
# Slow decays: log_a in (-0.02, -1e-4), so a chunk of 128 keeps about a
# quarter of its state and the gradient carried between chunks (D_k g_k)
# counts; the model's range (-0.5, -1e-3) keeps e^-32 of it at chunk 128.
SSD_BWD_SHAPES = (
    (1, 4096, 80, 64, 128, 128, "bfloat16", False, False),
    (1, 4096, 80, 64, 128, 128, "bfloat16", True, True),
    (2, 512, 8, 64, 128, 128, "float32", True, True),
    (2, 256, 8, 64, 128, 64, "bfloat16", True, True),
    (1, 40, 3, 64, 128, 1, "bfloat16", True, False),
    (1, 96, 3, 64, 128, 96, "bfloat16", False, True),
    (2, 64, 5, 7, 17, 16, "float32", True, True),
    (2, 50, 3, 7, 17, 1, "float32", False, False),
    (1, 256, 7, 128, 256, 32, "bfloat16", True, True),
    (1, 1152, 80, 64, 128, 128, "bfloat16", True, True),
    (1, 256, 3, 128, 64, 128, "bfloat16", True, True),
    (1, 2048, 7, 72, 128, 64, "bfloat16", True, True),
)
# the route ssd_chunk.bwd_route must give each entry: the bf16 entries at
# chunks of 128 and 64 with N 64 or 128 on the tensor cores, the rest
# (float32, chunks of 1 and 96, N 17, N 256) on the FMA kernels
SSD_BWD_ROUTES = ("wgmma", "wgmma", "cells", "wgmma", "cells", "cells", "cells", "cells",
                  "cells", "wgmma", "wgmma", "wgmma")
# Limits, relative to the largest |value| of the reference's gradient: dx,
# db and dc are float32 sums rounded once to the inputs' type on both
# sides, so they take check_ssd's limits for y (bf16 two ulps, 2^-6; float32
# 1e-5); dlog_a, h_in and g are float32 on both sides: 1e-5, check_ssd's
# limit for h_final.  The same limits hold the kernels and the plain
# backward against float64 autograd of the plain forward.
SSD_BWD_TOL = {"bfloat16": 2 * BF16_ULP, "float32": 1e-5}


def ssd_bwd_inputs(torch, rng, dev, bt, S, H, Pd, N, dtype, dh, slow):
    """x, log_a, b, c, dy, dh of one backward call; log_a in the model's
    range or the slow one."""
    def t(a, dt=dtype):
        return torch.as_tensor(a, device=dev).to(dt).contiguous()

    lo, hi = (1e-4, 0.02) if slow else (1e-3, 0.5)
    return (t(rng.normal(0, 1, (bt, S, H, Pd))), t(-rng.uniform(lo, hi, (bt, S, H)), torch.float32),
            t(rng.normal(0, 0.3, (bt, S, N))), t(rng.normal(0, 0.3, (bt, S, N))),
            t(rng.normal(0, 1, (bt, S, H, Pd))),
            t(rng.normal(0, 1, (bt, H, N, Pd)), torch.float32) if dh else None)


def grad_ratios(torch, got, want, dtype):
    """{name: max |err| / (limit x max |want|)} of (dx, dlog_a, db, dc)."""
    out = {}
    for name, g, w in zip(("dx", "dlog_a", "db", "dc"), got, want):
        rel = 1e-5 if name == "dlog_a" else SSD_BWD_TOL[dtype]
        err = float((g.double() - w.double()).abs().max())
        if not bool(torch.isfinite(g.float()).all()):
            err = math.inf
        out[name] = err / (rel * max(float(w.double().abs().max()), 1e-30))
    return out


@contextlib.contextmanager
def carry_dropped(torch, sc):
    """Inside the block, ``sc.ssd_bwd_states_plain`` walks back with the
    carry D_k g_k dropped (g_k = Q_{k+1}), so ``ssd_chunk_scan_bwd_plain``
    is the faulty backward that the checks must catch."""
    states = sc.ssd_bwd_states_plain

    def without_carry(x, log_a, b, c, chunk, dy, dh=None):
        hin, g = states(x, log_a, b, c, chunk, dy, dh)
        bt, S, H, Pd = x.shape
        nc, N = S // chunk, b.shape[-1]
        e = log_a.to(hin.dtype).reshape(bt, nc, chunk, H).cumsum(2).exp()
        ce = c.to(hin.dtype).reshape(bt, nc, chunk, 1, N) * e[..., None]
        q = torch.einsum("bnlhk,bnlhp->bnhkp", ce,
                         dy.to(hin.dtype).reshape(bt, nc, chunk, H, Pd))
        return hin, torch.cat([q[:, 1:], g[:, -1:]], 1)

    sc.ssd_bwd_states_plain = without_carry
    try:
        yield
    finally:
        sc.ssd_bwd_states_plain = states


def ssd_bwd_parity(torch, rng, dev, shapes=SSD_BWD_SHAPES):
    """The SSD backward's kernels against the plain backward
    (``ssd_chunk_scan_bwd_plain``, and ``ssd_bwd_states_plain`` for the
    state kernel's h_in and g) at ``shapes``, and both against float64
    autograd of the plain forward, within SSD_BWD_TOL; each shape on the
    route SSD_BWD_ROUTES names (``bwd_route``), every call launching its
    route's state and chunk kernels and ``ssd_bwd_sum`` once and the other
    route's none, and a repeated call equal bit for bit.  Then the autograd
    route (``ssd_chunk_scan`` on inputs that need a gradient) gives the
    wrapper's gradient bit for bit with one launch of each tensor-core
    kernel and none of the FMA ones, and the faulty plain
    backward that drops the carry D_k g_k crosses the limits.  → {kernel:
    max |err|} for the rows of SSD_BWD_ROWS."""
    from repro_torch.kernels import ssd_chunk as sc

    errs = {name: 0.0 for name in SSD_BWD_ROWS}
    counters = (sc.launches_bwd_state, sc.launches_bwd_chunk, sc.launches_bwd_sum,
                sc.launches_bwd_state_wgmma, sc.launches_bwd_chunk_wgmma)
    routes = dict(zip(SSD_BWD_SHAPES, SSD_BWD_ROUTES))
    for shape in shapes:
        bt, S, H, Pd, N, L, dtype, with_dh, slow = shape
        label = f"{shape}"
        route = sc.bwd_route(getattr(torch, dtype), L, N, Pd)
        print(f"[parity] ssd backward {label}: route {route}", flush=True)
        check(route == routes.get(shape, route), f"ssd backward {label}: route {route}, not "
              f"{routes.get(shape)}")
        x, la, b, c, dy, dh = ssd_bwd_inputs(torch, rng, dev, bt, S, H, Pd, N,
                                             getattr(torch, dtype), with_dh, slow)
        before = [k.value for k in counters]
        got = sc.ssd_chunk_scan_bwd(x, la, b, c, L, dy, dh)
        again = sc.ssd_chunk_scan_bwd(x, la, b, c, L, dy, dh)
        want_counts = [0, 0, 2, 2, 2] if route == "wgmma" else [2, 2, 2, 0, 0]
        counts = [k.value - v for k, v in zip(counters, before)]
        check(counts == want_counts, f"ssd backward {label}: launches {counts} in two calls, "
              f"not {want_counts}: each kernel of the {route} route once a call, the other "
              "route's none")
        check(all(torch.equal(p, q) for p, q in zip(got, again)),
              f"ssd backward {label}: a repeated call differs")
        want = sc.ssd_chunk_scan_bwd_plain(x, la, b, c, L, dy, dh)
        leaves = [t.double().requires_grad_(True) for t in (x, la, b, c)]
        y64, h64 = sc.ssd_chunk_scan_plain(*leaves, L)
        outs, cots = [y64], [dy.double()]
        if dh is not None:
            outs.append(h64)
            cots.append(dh.double())
        ref = torch.autograd.grad(outs, leaves, cots)
        del leaves, outs, y64, h64
        ratios = {f"kernel {k}": v for k, v in grad_ratios(torch, got, want, dtype).items()}
        ratios.update({f"kernel vs float64 {k}": v
                       for k, v in grad_ratios(torch, got, ref, dtype).items()})
        ratios.update({f"plain vs float64 {k}": v
                       for k, v in grad_ratios(torch, want, ref, dtype).items()})
        hin, g = sc.ssd_bwd_states(x, la, b, c, L, dy, dh)
        phin, pg = sc.ssd_bwd_states_plain(x, la, b, c, L, dy, dh)
        for name, p, q in (("h_in", hin, phin), ("g", g, pg)):
            ratios[f"state kernel {name}"] = float((p - q).abs().max()) / (
                1e-5 * max(float(q.abs().max()), 1e-30))
        worst = max(ratios.values())
        print(f"[parity] ssd backward {label}: worst err / limit {worst}: "
              + json.dumps(ratios), flush=True)
        check(worst <= 1.0, f"ssd backward {label}: err / limit {worst}")
        suffix = "_wgmma" if route == "wgmma" else ""
        name = "ssd_chunk_scan_bwd_state" + suffix
        errs[name] = max(errs[name], float((hin - phin).abs().max()),
                         float((g - pg).abs().max()))
        for name, i in (("ssd_chunk_scan_bwd_chunk" + suffix, 0),
                        ("ssd_chunk_scan_bwd_chunk" + suffix, 1),
                        ("ssd_chunk_scan_bwd_sum", 2), ("ssd_chunk_scan_bwd_sum", 3)):
            errs[name] = max(errs[name], float((got[i].double() - want[i].double()).abs().max()))
        if slow and with_dh and S // L > 1:
            with carry_dropped(torch, sc):
                bad = sc.ssd_chunk_scan_bwd_plain(x, la, b, c, L, dy, dh)
            cworst = max(grad_ratios(torch, bad, want, dtype).values())
            check(cworst > 1.0, f"ssd backward {label}: the control that drops the carry "
                  f"reads {cworst} of the limit, which cannot see it")
            print(f"[parity] ssd backward {label}: the plain backward that drops the carry "
                  f"D_k g_k reads {cworst} of the limit", flush=True)
        del got, again, want, ref, hin, g, phin, pg
        torch.cuda.empty_cache()

    # the autograd route: ssd_chunk_scan on inputs that need a gradient
    x, la, b, c, dy, dh = ssd_bwd_inputs(torch, rng, dev, 2, 256, 8, 64, 128, torch.bfloat16,
                                         True, True)
    leaves = [t.clone().requires_grad_(True) for t in (x, la, b, c)]
    before = [k.value for k in counters]
    y, h = sc.ssd_chunk_scan(*leaves, 64)
    routed = torch.autograd.grad((y, h), leaves, (dy, dh))
    check([k.value - v for k, v in zip(counters, before)] == [0, 0, 1, 1, 1],
          "ssd_chunk_scan's backward must launch each tensor-core backward kernel once and "
          "no FMA one")
    direct = sc.ssd_chunk_scan_bwd(x, la, b, c, 64, dy, dh)
    check(all(torch.equal(p, q) for p, q in zip(routed, direct)),
          "ssd_chunk_scan's autograd gradient differs from the backward wrapper's")
    y, _ = sc.ssd_chunk_scan(*leaves, 64)
    only_y = torch.autograd.grad(y, leaves, dy)
    direct = sc.ssd_chunk_scan_bwd(x, la, b, c, 64, dy, None)
    check(all(torch.equal(p, q) for p, q in zip(only_y, direct)),
          "ssd_chunk_scan's gradient with h_final unused differs from the wrapper's with no dh")
    print("[parity] ssd backward: the autograd route equals the wrapper bit for bit (h_final "
          "used and unused), one launch of each tensor-core kernel, none of the FMA ones",
          flush=True)
    return errs


# --------------------------------------------------------------------------- #
# phase 3-4: the main path                                                     #
# --------------------------------------------------------------------------- #

CELLS = [
    'df = pd.read_csv("events")\ndf.describe()',
    'f = df[df["x"] > 50]\nf.groupby("k").agg({"y": "mean", "z": "min", "x": "max"})',
    'df["g"].value_counts()',
    'df.sort_values("z", ascending=False).head(20)',
    "f.head(100)",
    'u = pd.read_csv("users")\ndf.join(u, on="i", how="left").head(100)',
    'df.join(u, on="i").groupby("segment").agg({"x": "mean"})',
]
USERS = 900_000  # the dimension table's rows; segment has 100,000 categories
THINK_S = 5.0


def catalog():
    from repro_torch.frame import Catalog, ColSpec, TableSpec

    cat = Catalog()
    cat.register(TableSpec(
        "events", nrows=ROWS, io_seconds=8.0, seed=2021,
        cols=(
            ColSpec("x", low=0.0, high=100.0),
            ColSpec("y", null_frac=0.2),
            ColSpec("z", low=-1e3, high=1e3, null_frac=0.05),
            ColSpec("k", kind="cat", n_categories=64),
            ColSpec("g", kind="cat", n_categories=1000),
            ColSpec("i", kind="int", low=0, high=1_000_000),
        ),
    ))
    cat.register(TableSpec(
        "users", nrows=USERS, io_seconds=1.0, seed=2103,
        cols=(
            ColSpec("i", kind="key"),  # 0 .. 899,999: about 10% of events.i miss
            ColSpec("segment", kind="cat", n_categories=100_000),
            ColSpec("score"),
        ),
    ))
    return cat


def run_notebook(torch, session, cells, sync, counts=None):
    """Run the cells with think time between them → (answers, ms per cell,
    and, given ``counts``, the launch counts after each cell)."""
    outs, lat, after = [], [], []
    for i, code in enumerate(cells):
        t0 = time.perf_counter()
        res = session.cell(code)
        d = res.to_pydict()
        if sync:
            torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
        outs.append(d)
        if counts is not None:
            after.append(counts())
        if i < len(cells) - 1 and session.engine.mode == "sim":
            session.think(THINK_S)
    return (outs, lat, after) if counts is not None else (outs, lat)


def compare(ref, got, label):
    import numpy as np

    exact = label.startswith(("cell3", "cell4", "cell5", "cell6"))
    check(set(ref) == set(got), f"{label}: columns {sorted(got)} != {sorted(ref)}")
    for col in ref:
        r, g = np.asarray(ref[col]), np.asarray(got[col])
        check(r.shape == g.shape, f"{label}/{col}: shape {g.shape} != {r.shape}")
        if r.dtype.kind in "OU" or exact:
            same = np.array_equal(r, g) if r.dtype.kind in "OU" else np.array_equal(
                r.astype(np.float64), g.astype(np.float64), equal_nan=True)
            check(same, f"{label}/{col}: not equal")
        else:
            # tests/test_backend_parity.py:390-395 (end-to-end session parity)
            np.testing.assert_allclose(g.astype(np.float64), r.astype(np.float64),
                                       rtol=2e-3, atol=1e-5, err_msg=f"{label}/{col}")


def main_path(torch, ops, BK, record):
    from repro_torch.frame import Session

    cat = catalog()
    print(f"[main] table events: {ROWS} rows x 6 columns, users: {USERS} rows x 3 columns; "
          "numpy session first", flush=True)
    ref_s = Session(catalog=cat, mode="sim", kernel_backend="numpy")
    ref, ref_lat = run_notebook(torch, ref_s, CELLS, sync=False)
    print("[main] numpy session latencies ms: " + json.dumps(ref_lat))

    cuda_s = Session(catalog=cat, mode="sim", kernel_backend="cuda")
    BK.reset_breakers()
    ops.reset_launch_counts()  # counts start at 0 just before the main path
    with record():
        got, lat, after = run_notebook(torch, cuda_s, CELLS, sync=True,
                                       counts=ops.launch_counts)
    launches = ops.launch_counts()
    for cell, names in ((6, ("join_probe",)), (7, ("join_probe", "segment_reduce"))):
        for name in names:
            n = after[cell - 1][name] - after[cell - 2][name]
            check(n > 0, f"cell {cell}: {name} did not launch")
    print("[main] launches in the join cells 6 and 7: " + json.dumps(
        {name: after[6][name] - after[4][name] for name in DATAFRAME}))
    snap = BK.breaker_board().snapshot()
    for i, (r, g) in enumerate(zip(ref, got)):
        compare(r, g, f"cell{i + 1}")
    print(f"[main] 10M-row notebook matched the numpy session ({len(CELLS)} cells)")
    print("[main] cuda session latencies ms: " + json.dumps(lat))
    print("[main] launches: " + json.dumps(launches))
    for name in DATAFRAME:
        check(launches[name] > 0, f"kernel {name} never launched on the main path")
    cuda_keys = {k: v for k, v in snap.items() if k.endswith("|cuda")}
    for key, st in cuda_keys.items():
        check(st["failures"] == 0 and st["fallbacks"] == 0, f"breaker {key}: {st}")
    check(cuda_keys, "no cuda dispatch reached the breaker board")
    print("[main] breakers: zero failures and fallbacks on cuda for "
          + ", ".join(sorted(k.split("|")[0] for k in cuda_keys)))
    return ref, got, launches, lat


# the device functions of csrc/segment_reduce.cu, for the trace's split
SEGMENT_KERNELS = ("count_shared", "count_global", "fill_neutral", "sort_hist",
                   "sort_scan_tiles", "sort_scan_digits", "sort_scatter", "fold_first",
                   "fold_level")


def trace_notebook(torch, tag="[trace]"):
    """The cuda notebook once more, each cell under torch.profiler: wall ms,
    device ms in kernels and in copies, and the top kernels by device time.
    Measurement only; launch counts were read before this run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.frame import Session

    s = Session(catalog=catalog(), mode="sim", kernel_backend="cuda")
    for i, code in enumerate(CELLS):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            s.cell(code).to_pydict()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        copy = sum(e.self_device_time_total for e in dev if e.key.startswith("Mem")) / 1e3
        kern = sorted(((e.self_device_time_total / 1e3, e.key) for e in dev
                       if not e.key.startswith("Mem")), reverse=True)
        busy = sum(t for t, _ in kern)
        seg = sum(t for t, k in kern if any(f in k for f in SEGMENT_KERNELS))
        print(f"{tag} cell{i + 1}: wall {wall} ms, device kernels {busy} ms "
              f"(segment_reduce {seg} ms), device copies {copy} ms, device idle "
              f"{100 * (1 - (busy + copy) / wall)}%; "
              "top: " + ", ".join(f"{k[:60]} {t}" for t, k in kern[:3]))
        if i < len(CELLS) - 1:
            s.think(THINK_S)


def real_mode(torch, ref):
    from repro_torch.frame import Session

    s = Session(catalog=catalog(), mode="real", kernel_backend="cuda")
    s.engine.start_background()
    try:
        lat = []
        outs = []
        for i, code in enumerate(CELLS[:2]):
            t0 = time.perf_counter()
            outs.append(s.cell(code).to_pydict())
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t0) * 1e3)
            if i == 0:
                time.sleep(2.0)  # think time: the background worker runs
    finally:
        s.engine.stop_background()
    for i, (r, g) in enumerate(zip(ref, outs)):
        compare(r, g, f"cell{i + 1}-real")
    print("[real] latencies ms (describe, filter+groupby): "
          + json.dumps(lat))


# --------------------------------------------------------------------------- #
# phase 3c: the notebook over a data mesh of four shards on one card            #
# --------------------------------------------------------------------------- #

MESH_SHARDS = 4  # dist.use_mesh([cuda:0] * 4): two of the 8 partitions a shard
ACCOUNTS = 4_000_000  # int64 keys, 32 MB: above JOIN_BROADCAST_MAX_BYTES (8 MiB)
AUTO_CELLS = [
    'df = pd.read_csv("events")\ndf.describe()',
    'a = pd.read_csv("accounts")\ndf.join(a, on="i").head(100)',
]
# the op families the seven cells and the declared mean reach on the
# sharded path (cell 2's groupby reads an uncached filter, which is left to
# the fusion lowering; the mean runs in think time as a sharded UnitBatch)
DIST_FAMILIES = ("stats", "stats_raws", "value_counts", "topk", "groupby", "join_build",
                 "join_probe")
DIST_KERNELS = ("masked_stats", "segment_reduce", "topk", "join_probe")
# the sharded calls of frame/dist.py, each with the kernel it must launch
DIST_CALLS = {"stats_combined": "masked_stats", "stats_raws": "masked_stats",
              "segment_fold": "segment_reduce", "topk_winners": "topk",
              "join_probe": "join_probe"}


def dist_catalog():
    from repro_torch.frame import ColSpec, TableSpec

    cat = catalog()
    cat.register(TableSpec(
        "accounts", nrows=ACCOUNTS, io_seconds=1.0, seed=2203,
        cols=(ColSpec("i", kind="key"), ColSpec("tier", kind="cat", n_categories=16),
              ColSpec("balance", low=0.0, high=1e4)),
    ))
    return cat


def launches_inside(ops, dist):
    """Context manager that counts the kernel launches made inside each
    sharded call of ``frame/dist.py`` (calls pass straight through)."""
    from contextlib import contextmanager

    inside = {name: dict.fromkeys(DIST_KERNELS, 0) for name in DIST_CALLS}
    originals = {name: getattr(dist, name) for name in DIST_CALLS}

    def wrap(name):
        def call(*args, **kwargs):
            before = ops.launch_counts()
            try:
                return originals[name](*args, **kwargs)
            finally:
                after = ops.launch_counts()
                for k in DIST_KERNELS:
                    inside[name][k] += after[k] - before[k]
        return call

    @contextmanager
    def watch():
        for name in DIST_CALLS:
            setattr(dist, name, wrap(name))
        try:
            yield
        finally:
            for name, fn in originals.items():
                setattr(dist, name, fn)

    return inside, watch


def declared_mean(torch, s):
    """``m = df.mean()`` declared, not shown; the engine computes it in think
    time (drained to the end), then the cell ``m`` shows it → (answer, ms
    of the showing cell)."""
    s.cell("m = df.mean()")
    s.think(THINK_S)
    s.drain()
    t0 = time.perf_counter()
    out = s.cell("m").to_pydict()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def bit_equal_cells(host, got, label):
    from repro_torch.frame.table import pydict_equal

    for i, (h, g) in enumerate(zip(host, got)):
        check(pydict_equal(h, g), f"{label} cell {i + 1}: not bit for bit the host path's")


def sharded_cells(torch, ops, BK, dist, cat, host, label, record=None):
    """The seven cells and the declared mean under ``use_sharded("on")`` on
    the installed mesh, bit for bit against ``host`` (the host path's
    answers): every family the cells reach dispatched sharded, its kernel
    launched inside the sharded call, no "sharded" breaker failed.  Returns
    (the launch counts, the cells' walls)."""
    import contextlib

    from repro_torch.frame import Session

    (host_cells, host_lat), (host_mean, host_mean_ms, host_batches) = host
    BK.reset_breakers()
    dist.reset_dispatch_counts()
    inside, watch = launches_inside(ops, dist)
    ops.reset_launch_counts()  # counts start at 0 just before the sharded run
    with dist.use_sharded("on"), (record or contextlib.nullcontext)(), watch():
        s = Session(catalog=cat, mode="sim", kernel_backend="cuda")
        got, lat, after = run_notebook(
            torch, s, CELLS, sync=True,
            counts=lambda: (ops.launch_counts(), dist.dispatch_counts()))
        got_mean, mean_ms = declared_mean(torch, s)
    launches = ops.launch_counts()
    counts = dist.dispatch_counts()
    ex = s.engine.executor.stats
    snap = BK.breaker_board().snapshot()
    bit_equal_cells(host_cells + [host_mean], got + [got_mean], label)
    check(host_batches == 0 and ex.sharded_batches >= 1,
          f"{label} sharded UnitBatches: {ex.sharded_batches} (host path {host_batches})")
    prev = (dict.fromkeys(launches, 0), {})
    for i, (cell_launches, cell_counts) in enumerate(after):
        print(f"{label} cell{i + 1}: wall {lat[i]} ms (host path {host_lat[i]} ms); "
              "sharded calls " + json.dumps({f: cell_counts.get(f, 0) - prev[1].get(f, 0)
                                             for f in sorted(cell_counts)})
              + ", launches " + json.dumps({k: cell_launches[k] - prev[0][k]
                                            for k in DIST_KERNELS}))
        prev = (cell_launches, cell_counts)
    print(f"{label} declared mean shown after think time: {mean_ms} ms (host path "
          f"{host_mean_ms} ms)")
    print(f"{label} seven cells and the mean bit for bit against the host path; sharded "
          "calls " + json.dumps(counts) + f"; executor sharded_batches {ex.sharded_batches}, "
          f"units_sharded {ex.units_sharded}; launches inside the sharded calls "
          + json.dumps(inside), flush=True)
    for fam in DIST_FAMILIES:
        check(counts.get(fam, 0) > 0, f"{label} no sharded {fam} call: {counts}")
    for name, kernel in DIST_CALLS.items():
        check(inside[name][kernel] > 0, f"{label} {name} launched no {kernel}")
    sharded = {k: st for k, st in snap.items() if k.endswith("|sharded")}
    check(sharded, f"{label} no sharded call reached the breaker board")
    for key, st in sharded.items():
        check(st["state"] == "closed" and st["failures"] == 0 and st["fallbacks"] == 0,
              f"{label} breaker {key}: {st}")
    del s
    gc.collect()
    return launches, lat


def auto_join(torch, BK, dist, cat, label):
    """Under "auto": describe stays on the host path (the planner has no
    sharded priors: ``no_estimate``) and the join against the
    4,000,000-row ``accounts`` takes the partition-parallel build by its
    size alone, bit for bit against the host path."""
    from repro_torch.frame import Session

    check(BK.JOIN_BROADCAST_MAX_BYTES == 8 << 20, "JOIN_BROADCAST_MAX_BYTES not 8 MiB")
    check(ACCOUNTS * 8 > BK.JOIN_BROADCAST_MAX_BYTES, "accounts below the threshold")
    dist.reset_dispatch_counts()
    with dist.use_sharded("auto"):
        s = Session(catalog=cat, mode="sim", kernel_backend="cuda")
        auto, auto_lat = run_notebook(torch, s, AUTO_CELLS, sync=True)
        auto_counts = dist.dispatch_counts()
        decisions = dict(s.engine.cost_model.planner_decisions)
    del s
    gc.collect()
    with dist.use_sharded("off"):
        ref, ref_lat = run_notebook(torch, Session(catalog=cat, mode="sim",
                                                   kernel_backend="cuda"),
                                    AUTO_CELLS, sync=True)
    bit_equal_cells(ref, auto, f"{label} auto")
    check(auto_counts.get("join_build") == 1 and auto_counts.get("join_probe", 0) > 0,
          f"{label} auto: the accounts join did not take the sharded build: {auto_counts}")
    check("stats" not in auto_counts and decisions.get("describe|sharded|no_estimate", 0),
          f"{label} auto: describe left the host path: {auto_counts} {decisions}")
    print(f"{label} auto: describe on the host path (describe|sharded|no_estimate "
          f"{decisions['describe|sharded|no_estimate']}), the {ACCOUNTS}-row accounts "
          f"join on the partition-parallel build: {json.dumps(auto_counts)}; walls ms "
          f"{auto_lat} (host path {ref_lat}); bit for bit", flush=True)
    gc.collect()


def dist_phase(torch, ops, BK, record, smi):
    """The seven cells over ``use_mesh([cuda:0] * 4)`` under
    ``use_sharded("on")``, bit for bit against the same cells under "off"
    (the host path) on the same catalog, then a mean computed in think time
    (one sharded UnitBatch); every family the cells reach dispatched
    sharded, its kernel launched inside the sharded call, no "sharded"
    breaker failed.  Then, under "auto", a join against the
    4,000,000-row ``accounts`` engages the partition-parallel build by its
    size alone while describe stays on the host path (no priors).  Where
    the cards number 2^k >= 2, all of it again over ``data_mesh()``, every
    card a shard.  Returns the emulated mesh's launch counts."""
    from repro_torch.frame import Session, dist

    cat = dist_catalog()
    mesh = [torch.device("cuda", 0)] * MESH_SHARDS
    cards = torch.cuda.device_count()
    print(f"[dist] {smi}; {cards} card(s); mesh of {MESH_SHARDS} shards on cuda:0, "
          f"JOIN_BROADCAST_MAX_BYTES {BK.JOIN_BROADCAST_MAX_BYTES}", flush=True)
    with dist.use_mesh(mesh):
        check(dist.device_count() == MESH_SHARDS, "use_mesh did not install the mesh")
        with dist.use_sharded("off"):
            hs = Session(catalog=cat, mode="sim", kernel_backend="cuda")
            host = run_notebook(torch, hs, CELLS, sync=True)
            host_mean = (*declared_mean(torch, hs), hs.engine.executor.stats.sharded_batches)
        del hs
        gc.collect()
        launches, lat = sharded_cells(torch, ops, BK, dist, cat, (host, host_mean), "[dist]",
                                      record)
        print(f"[dist] sharded describe wall {lat[0]} ms (PR 25's run 2: "
              f"{PR25_DESCRIBE_3C_MS} ms, before one device key a card)", flush=True)
        with dist.use_sharded("on"):
            trace_notebook(torch, "[dist-trace]")  # measurement only
        gc.collect()
        auto_join(torch, BK, dist, cat, "[dist]")

    # every card a shard, where their count makes a mesh (2^k >= 2)
    if cards >= 2 and cards & (cards - 1) == 0:
        label = f"[dist {cards} cards]"
        mesh = dist.data_mesh()
        check(mesh == tuple(torch.device("cuda", i) for i in range(cards)),
              f"data_mesh() did not span the cards: {mesh}")
        for i in range(cards):
            torch.cuda.reset_peak_memory_stats(i)
        sharded_cells(torch, ops, BK, dist, cat, (host, host_mean), label)
        peak = [torch.cuda.max_memory_allocated(i) for i in range(cards)]
        check(all(b > 0 for b in peak), f"{label} a card took no shard: {peak}")
        print(f"{label} peak bytes allocated on each card: {peak}", flush=True)
        auto_join(torch, BK, dist, cat, label)
    else:
        print(f"[dist] {cards} card(s): the multi-card mesh (data_mesh() over every card) "
              "did not run", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# --------------------------------------------------------------------------- #
# phase 3d: the engine's contracts on the card                                  #
# --------------------------------------------------------------------------- #

# the filter chains of the fusion check, each on its own filter node (one
# consumer: the fusable shape): cell 2's filter → groupby, a filter →
# describe, a filter → sort + head(20) (a sort with a limit)
FUSED_KEYS = ("fused:filter|groupby_agg", "fused:filter|describe",
              "fused:filter|sort_values:topk")
WARM_H2D_MAX = 1 << 20  # bytes a warmed describe may copy host → device
PR25_DESCRIBE_3C_MS = 1344.91  # phase 3c's sharded describe, PR 25's run 2


def h2d_copies(prof):
    """(ms, bytes) of the host → device copies in a finished profile, read
    from its exported trace (the summary tables carry no byte counts)."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text()).get("traceEvents", [])
    copies = [e for e in events if e.get("cat") == "gpu_memcpy" and "HtoD" in e.get("name", "")]
    check(all("bytes" in e.get("args", {}) for e in copies),
          "[contracts] a host → device copy in the trace has no byte count")
    return (sum(e.get("dur", 0) for e in copies) / 1e3,
            sum(int(e["args"]["bytes"]) for e in copies))


def profiled_cells(torch, s, cells):
    """The cells with think time between them, each under torch.profiler →
    (answers, wall ms, [(h2d ms, h2d bytes)])."""
    from torch.profiler import ProfilerActivity, profile

    outs, lat, h2d = [], [], []
    for i, code in enumerate(cells):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            outs.append(s.cell(code).to_pydict())
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t0) * 1e3)
        h2d.append(h2d_copies(prof))
        if i < len(cells) - 1:
            s.think(THINK_S)
    return outs, lat, h2d


def free_sessions():
    import torch

    gc.collect()  # a session's engine and runtime form reference cycles
    torch.cuda.empty_cache()


def tables_bit_equal(a, b) -> bool:
    """Two PTables with the same rows, column for column, byte for byte
    (data and validity), NaN payloads included: ``pydict_equal`` on 10M-row
    results would decode and compare every string in Python."""
    import numpy as np

    pa, pb = a.concat(), b.concat()
    if pa.order != pb.order or pa.nrows != pb.nrows:
        return False
    for name in pa.order:
        ca, cb = pa.columns[name], pb.columns[name]
        if ca.data.dtype != cb.data.dtype or not np.array_equal(
                np.ascontiguousarray(ca.data).view(np.uint8),
                np.ascontiguousarray(cb.data).view(np.uint8)):
            return False
        if not np.array_equal(ca.valid_mask(), cb.valid_mask()):
            return False
    return True


def contracts_warm(torch, BK, cold, cold_lat):
    """(a) ``warm_device_cache`` on the materialised ``events``, then cells
    1-5, each profiled: answers bit for bit the unwarmed cuda session's
    (phase 3's), and describe copying under 1 MiB host → device."""
    from repro_torch.frame import Session
    from repro_torch.frame.table import pydict_equal

    s = Session(catalog=catalog(), mode="sim", kernel_backend="cuda")
    s.cell('df = pd.read_csv("events")')
    node = s._runner.env["df"].node
    table = s.engine.value_of(node)
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    BK.warm_device_cache(table)
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t0) * 1e3
    warm_bytes = torch.cuda.memory_allocated() - mem0
    print(f"[contracts] (a) warm_device_cache(events): {warm_ms} ms, {warm_bytes} bytes added "
          f"on the card ({len(table.partitions)} partitions, {table.nrows} rows)", flush=True)
    got, lat, h2d = profiled_cells(torch, s, CELLS[:5])
    check(s._runner.env["df"].node is node, "[contracts] (a) cell 1 read another events node "
          "than the warmed one")
    for i, (want, g) in enumerate(zip(cold, got)):
        check(pydict_equal(want, g), f"[contracts] (a) cell {i + 1} on the warmed table is not "
              "bit for bit the unwarmed cuda session's")
    for i in range(len(got)):
        print(f"[contracts] (a) cell{i + 1} warmed: wall {lat[i]} ms (phase 3 cold "
              f"{cold_lat[i]} ms), host → device copies {h2d[i][0]} ms, {h2d[i][1]} bytes",
              flush=True)
    check(h2d[0][1] < WARM_H2D_MAX, f"[contracts] (a) the warmed describe copied {h2d[0][1]} "
          f"bytes host → device (limit {WARM_H2D_MAX})")
    del s, table
    free_sessions()


def contracts_progressive(torch):
    """(b) describe, a groupby and value_counts as progressive interactions:
    a first estimate below full coverage, and ``upgrade()`` bit for bit what
    a fresh cuda session shows."""
    from repro_torch.frame import Session
    from repro_torch.frame.table import pydict_equal

    queries = {
        "describe": lambda df: df.describe(),
        "groupby": lambda df: df.groupby("k").agg({"y": "mean", "z": "min", "x": "max"}),
        "value_counts": lambda df: df["g"].value_counts(),
    }
    s = Session(catalog=catalog(), mode="sim", kernel_backend="cuda")
    df = s.read_table("events")
    upgraded, covs = {}, {}
    for name, build in queries.items():
        t0 = time.perf_counter()
        pr = s.interact(build(df), progressive=True)
        est = pr.estimate()
        first_ms = (time.perf_counter() - t0) * 1e3
        covs[name] = est.coverage
        check(est.coverage < 1.0 and not est.exact,
              f"[contracts] (b) {name}: the first estimate was exact (coverage {est.coverage})")
        t0 = time.perf_counter()
        upgraded[name] = pr.upgrade().to_pydict()
        torch.cuda.synchronize()
        print(f"[contracts] (b) {name}: first estimate in {first_ms} ms at coverage "
              f"{est.coverage}, upgrade() {(time.perf_counter() - t0) * 1e3} ms", flush=True)
    del s, df, pr
    free_sessions()
    s = Session(catalog=catalog(), mode="sim", kernel_backend="cuda")
    df = s.read_table("events")
    for name, build in queries.items():
        check(pydict_equal(upgraded[name], s.show(build(df)).to_pydict()),
              f"[contracts] (b) {name}: upgrade() is not bit for bit a fresh session's show")
    print("[contracts] (b) upgrade() bit for bit a fresh cuda session's show for "
          + ", ".join(queries), flush=True)
    del s, df
    free_sessions()


def contracts_batched(torch):
    """(c) describe, a groupby, value_counts, a filter and a full sort drained
    in think time under ``batching=True`` and ``False``: bit for bit."""
    from repro_torch.frame import Session

    def run(batching):
        s = Session(catalog=catalog(), mode="sim", kernel_backend="cuda", batching=batching)
        df = s.read_table("events")
        nodes = [df.describe().node, df.groupby("k").agg({"x": "mean", "y": "sum"}).node,
                 df["k"].value_counts().node, df[df["x"] > 50.0].node, df.sort_values("x").node]
        t0 = time.perf_counter()
        s.think(1000.0)
        s.drain()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        return s, [s.engine.value_of(n) for n in nodes], ms

    sb, vb, ms_b = run(True)
    su, vu, ms_u = run(False)
    nb, nu = sb.engine.executor.stats.units_batched, su.engine.executor.stats.units_batched
    check(nb > 0 and nu == 0, f"[contracts] (c) units_batched {nb} batched, {nu} unbatched")
    for i, (a, b) in enumerate(zip(vb, vu)):
        check(tables_bit_equal(a, b), f"[contracts] (c) node {i}: batched != unbatched")
    print(f"[contracts] (c) five nodes drained in think time, batched ({nb} units in "
          f"{sb.engine.executor.stats.batches_run} batches, {ms_b} ms) == unbatched ({ms_u} "
          "ms), bit for bit", flush=True)
    del sb, su, vb, vu
    free_sessions()


def contracts_fused(torch):
    """(d) three filter chains in a session whose cost model favours the
    fused lowering (injected samples), then with ``planner=False``: every
    ``fused:`` key lowered on cuda, answers bit for bit."""
    from repro_torch.frame import Session

    def run(planner):
        s = Session(catalog=catalog(), mode="sim", kernel_backend="cuda", planner=planner)
        if planner:
            cm = s.engine.cost_model
            for rows in (1e5, 1e6, 1e7):
                for key in ("filter", "describe", "groupby_agg", "sort_values:topk"):
                    cm.add_sample(key, "cuda", rows, 1e-8 * rows)
                    cm.add_sample(key, "numpy", rows, 2e-8 * rows)
                for key in FUSED_KEYS:
                    cm.add_sample(key, "cuda", rows, 1e-10 * rows)
            cm.calibrate()
        df = s.read_table("events")
        t0 = time.perf_counter()
        out = [
            s.show(df[df["x"] > 50].groupby("k").agg({"y": "mean", "z": "min", "x": "max"})),
            s.show(df[df["x"] > 25].describe()),
            s.engine.display(s.engine.add(
                "sort_values", parents=[df[df["x"] > 75].node],
                kwargs={"by": "z", "ascending": False, "limit": 20})),
        ]
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        return [o.to_pydict() for o in out], dict(s.engine.cost_model.planner_report()), ms

    from repro_torch.frame.table import pydict_equal

    fused, report, ms_f = run(True)
    free_sessions()
    for key in FUSED_KEYS:
        check(report.get(f"{key}|cuda|fused", 0) >= 1,
              f"[contracts] (d) {key} was not lowered fused on cuda: {report}")
    unfused, report_off, ms_u = run(False)
    free_sessions()
    check(report_off == {}, f"[contracts] (d) planner=False recorded decisions {report_off}")
    for key, a, b in zip(FUSED_KEYS, fused, unfused):
        check(pydict_equal(a, b), f"[contracts] (d) {key}: fused != unfused")
    print(f"[contracts] (d) fused ({ms_f} ms; " + json.dumps(
        {k: v for k, v in report.items() if k.startswith("fused:")}) + f") == unfused "
          f"({ms_u} ms), bit for bit", flush=True)


# cells 1-4's work declared before it is shown, so that think time has
# background units to run (and to fail)
DECLARE = ('df = pd.read_csv("events")\nf = df[df["x"] > 50]\n'
           'gb = f.groupby("k").agg({"y": "mean", "z": "min", "x": "max"})\n'
           'vc = df["g"].value_counts()\nd = df.describe()')


def faulty_cells(torch, s):
    """Cells 1-4 after their work was declared and think time ran it."""
    s.cell(DECLARE)
    s.think(THINK_S)
    return run_notebook(torch, s, CELLS[:4], sync=True)


def contracts_faults(torch, BK, ref, cold):
    """(e) background faults: every unit failing in think time leaves cells
    1-4 bit for bit the clean cuda session's (phase 3's); half the kernel
    dispatches failing in think time leaves them within the parity
    tolerances of the numpy session's, with the fallbacks on the board."""
    from repro_torch.core import FaultPlan, FaultSpec
    from repro_torch.frame import Session
    from repro_torch.frame.table import pydict_equal

    plan = FaultPlan([FaultSpec("exec.unit", rate=1.0)], seed=1)
    s = Session(catalog=catalog(), mode="sim", kernel_backend="cuda", fault_plan=plan)
    got, lat = faulty_cells(torch, s)
    n_faults = s.engine.metrics.n_background_faults
    check(n_faults >= 1, "[contracts] (e) no background unit fault fired")
    for i, (want, g) in enumerate(zip(cold, got)):
        check(pydict_equal(want, g), f"[contracts] (e) cell {i + 1} under background unit "
              "faults is not bit for bit the clean cuda session's")
    print(f"[contracts] (e) every background unit failing ({n_faults} faults, "
          f"{s.engine.metrics.quarantines} quarantines): cells 1-4 bit for bit the clean "
          f"session's; walls ms {lat}", flush=True)
    del s
    free_sessions()

    BK.reset_breakers()
    plan = FaultPlan([FaultSpec("kernel", mode="raise", rate=0.5, background_only=True)],
                     seed=2)
    s = Session(catalog=catalog(), mode="sim", kernel_backend="cuda", fault_plan=plan)
    got, lat = faulty_cells(torch, s)
    for i, (want, g) in enumerate(zip(ref, got)):
        compare(want, g, f"cell{i + 1}-kernel-faults")
    snap = BK.breaker_board().snapshot()
    failed = {k: st["failures"] for k, st in snap.items()
              if k.endswith("|cuda") and st["failures"]}
    served = sorted({key for key, bk in s.engine.cost_model.samples() if bk == "numpy"})
    check(plan.total_fired() >= 1 and failed, f"[contracts] (e) no cuda breaker recorded a "
          f"kernel fault: {snap}")
    check(served, "[contracts] (e) no sample was labelled as served by the numpy fallback")
    print(f"[contracts] (e) half the background kernel dispatches failing ({plan.total_fired()} "
          f"fired): cells 1-4 within the parity tolerances of the numpy session; breaker "
          f"failures " + json.dumps(failed) + "; samples served by numpy for "
          + ", ".join(served) + f"; walls ms {lat}", flush=True)
    del s
    BK.reset_breakers()
    free_sessions()


def contracts_phase(torch, ops, BK, ref, cold, cold_lat):
    """Phase 3d: the engine's internal contracts on the card, on phase 3's
    10M-row ``events`` in cuda sessions; returns the dataframe kernels'
    launches in the phase."""
    before = ops.launch_counts()
    t0 = time.perf_counter()
    contracts_warm(torch, BK, cold, cold_lat)
    contracts_progressive(torch)
    contracts_batched(torch)
    contracts_fused(torch)
    contracts_faults(torch, BK, ref, cold)
    after = ops.launch_counts()
    launches = {k: after[k] - before[k] for k in DATAFRAME}
    print("[contracts] launches in phase 3d: " + json.dumps(launches)
          + f"; phase took {time.perf_counter() - t0} s", flush=True)
    for name in ("masked_stats", "segment_reduce", "topk", "filter_compact"):
        check(launches[name] > 0, f"[contracts] {name} never launched in phase 3d")
    return launches


# --------------------------------------------------------------------------- #
# phase 3b: the examples and the serve launcher on the card                     #
# --------------------------------------------------------------------------- #

# The dataframe examples' answers against a numpy session's, under the
# parity tolerances of tests/test_backend_parity.py:51-54 (describe's count
# exact, mean rtol 1e-4 / atol 1e-5, std rtol 1e-3 / atol 1e-4, min and max
# rtol 1e-5; group means as means; everything else exact), and the kernels
# each example's cells reach.
STAT_TOL = {"count": (0.0, 0.0), "mean": (1e-4, 1e-5), "std": (1e-3, 1e-4),
            "min": (1e-5, 0.0), "max": (1e-5, 0.0)}
EXAMPLE_KERNELS = {"quickstart": ("masked_stats",),
                   "interactive_session": ("segment_reduce", "filter_compact", "masked_stats")}


def example(name):
    """``examples/torch_<name>.py`` as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(f"torch_{name}",
                                                  ROOT / "examples" / f"torch_{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def quiet(fn, *args, **kwargs):
    """``fn(...)`` with its standard output kept → (result, output)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kwargs)
    return out, buf.getvalue()


def compare_answer(want, got, code):
    import numpy as np

    plain = [a.to_pydict() if hasattr(a, "to_pydict") else list(a) for a in (want, got)]
    want, got = plain
    if isinstance(want, list):
        check(got == want, f"{code}: {got} != {want}")
        return
    check(list(got) == list(want), f"{code}: columns {list(got)} != {list(want)}")
    stats = want.get("stat")
    for col, w in want.items():
        g = got[col]
        check(g.shape == w.shape, f"{code}/{col}: shape {g.shape} != {w.shape}")
        if w.dtype.kind in "OUS":
            check(np.array_equal(g, w), f"{code}/{col}: not equal")
        elif stats is not None:
            for i, stat in enumerate(stats):
                rtol, atol = STAT_TOL[stat]
                np.testing.assert_allclose(float(g[i]), float(w[i]), rtol=rtol, atol=atol,
                                           err_msg=f"{code}/{col}/{stat}")
        elif ".mean()" in code:
            np.testing.assert_allclose(g.astype(np.float64), w.astype(np.float64),
                                       rtol=STAT_TOL["mean"][0], atol=STAT_TOL["mean"][1],
                                       err_msg=f"{code}/{col}")
        else:
            check(np.array_equal(g, w, equal_nan=True), f"{code}/{col}: not equal")


def dataframe_example(torch, ops, BK, name):
    """One dataframe example in a cuda session against the same program in
    a numpy session → the kernels' launches in the cuda run."""
    from repro_torch.frame import api
    from repro_torch.frame.runtime import FrameRuntime

    mod = example(name)
    cells, first = [], {}
    cell, planned, kwargs = api.Session.cell, FrameRuntime._planned_backend, mod.session_kwargs

    def recording_cell(self, code):
        out = cell(self, code)
        cells.append((code, out))
        return out

    def recording_plan(self, key, rows):
        bk = planned(self, key, rows)
        first.setdefault(key, bk)
        return bk

    api.Session.cell = recording_cell
    try:
        mod.session_kwargs = lambda device: {"kernel_backend": "numpy", "device": "cpu"}
        ref, _ = quiet(mod.main, [])
        ref_cells, cells[:] = list(cells), []
        mod.session_kwargs = kwargs
        FrameRuntime._planned_backend = recording_plan
        BK.reset_breakers()
        ops.reset_launch_counts()  # counts start at 0 just before the example
        got, _ = quiet(mod.main, [])
        torch.cuda.synchronize()
        launches = ops.launch_counts()
    finally:
        api.Session.cell, FrameRuntime._planned_backend = cell, planned
        mod.session_kwargs = kwargs
    check([c for c, _ in cells] == [c for c, _ in ref_cells], f"{name}: other cells ran")
    shown = [(c, a) for c, a in cells if a is not None]
    check(len(shown) == len(got["answers"]), f"{name}: answers and cells differ")
    for (code, g), (_, w) in zip(shown, [(c, a) for c, a in ref_cells if a is not None]):
        compare_answer(w, g, f"{name}: {code.strip()}")
    check(got["latencies"] == ref["latencies"], f"{name}: simulated latencies "
          f"{got['latencies']} != the numpy session's {ref['latencies']}")
    for kernel in EXAMPLE_KERNELS[name]:
        check(launches[kernel] > 0, f"{name}: {kernel} never launched")
    check(first and all(bk == "cuda" for bk in first.values()),
          f"{name}: a first dispatch did not take the kernels: {first}")
    snap = {k: v for k, v in BK.breaker_board().snapshot().items() if k.endswith("|cuda")}
    check(snap and all(st["failures"] == 0 and st["fallbacks"] == 0 for st in snap.values()),
          f"{name}: breakers {snap}")
    planner = got["session"].engine.cost_model.planner_report()
    print(f"[examples] {name}: {len(shown)} answers equal the numpy session's; simulated "
          f"latencies s {json.dumps(got['latencies'])} (equal); first dispatch per key "
          f"{json.dumps(first)}; planner decisions {json.dumps(planner)}; launches "
          + json.dumps({k: v for k, v in launches.items() if v}) + "; breakers: zero "
          "failures and fallbacks on cuda for " + ", ".join(sorted(k.split("|")[0]
                                                               for k in snap)), flush=True)
    return launches


def examples_on_card(torch, ops, BK):
    """Phase 3b → the kernels' launches over its runs."""
    import shutil

    from repro_torch.launch import serve as launch_serve

    total = {}

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    for name in EXAMPLE_KERNELS:
        add(dataframe_example(torch, ops, BK, name))

    # the LM examples and the serve launcher at smoke width, each twice
    ops.reset_launch_counts()
    serve = example("serve_opportunistic")
    (a, _), (b, _) = quiet(serve.main, []), quiet(serve.main, [])
    check(a["tokens"] == b["tokens"] and a["latencies"] == b["latencies"],
          "serve example: a fresh run gave other tokens or latencies")
    print(f"[examples] serve_opportunistic twice: tokens {json.dumps(a['tokens'])} and "
          f"simulated latencies s {json.dumps(a['latencies'])}, equal", flush=True)
    (a, _), (b, _) = quiet(launch_serve.main, []), quiet(launch_serve.main, [])
    check(a == b, "launch.serve: a fresh run gave other tokens or latencies")
    print("[examples] launch.serve twice: " + json.dumps(a) + ", equal", flush=True)
    train = example("train_lm")
    runs = []
    try:
        for i in range(2):
            ckpt = CKPT_ROOT / f"train_lm_{i}"
            shutil.rmtree(ckpt, ignore_errors=True)
            t0 = time.perf_counter()
            stats, _ = quiet(train.main, ["--ckpt-dir", str(ckpt)])
            runs.append((stats, time.perf_counter() - t0))
    finally:
        shutil.rmtree(CKPT_ROOT, ignore_errors=True)
    (s0, w0), (s1, w1) = runs
    check(s0.losses == s1.losses and s0.grad_norms == s1.grad_norms,
          "train example: a fresh run gave other losses")
    check(all(math.isfinite(x) for x in s0.losses) and s0.losses[-1] < s0.losses[0],
          f"train example: losses {s0.losses[0]} -> {s0.losses[-1]}")
    print(f"[examples] train_lm twice, {s0.steps} steps each in {w0} and {w1} s: losses "
          f"{s0.losses[0]} -> {s0.losses[-1]}, equal bit for bit; median step "
          f"{sorted(s0.step_times)[len(s0.step_times) // 2] * 1e3} ms", flush=True)
    torch.cuda.synchronize()
    add(ops.launch_counts())
    print("[examples] launches in phase 3b: " + json.dumps({k: v for k, v in total.items()
                                                            if v}), flush=True)
    return total


# --------------------------------------------------------------------------- #
# phase 5: timing at the main path's shapes                                    #
# --------------------------------------------------------------------------- #


def timed(torch, fn, iters, flush):
    """Mean ms per call with cold L2: a 128 MB write evicts it before each
    timed call."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        total += a.elapsed_time(b)
    return total / iters


def main_path_inputs(torch, name, shape, rng, dev):
    """Random inputs of one shape the main path gave a kernel (the shape
    tuples are those :func:`recorder` keeps)."""
    import numpy as np

    if name == "masked_stats":
        r, n = shape
        return (torch.as_tensor(rng.normal(50, 20, (r, n)).astype(np.float32), device=dev),
                torch.as_tensor(rng.random((r, n)) < 0.9, device=dev))
    if name == "segment_reduce":
        n, s, v, nbk, modes, vidx = shape
        return (torch.as_tensor(rng.integers(0, nbk, n).astype(np.int32), device=dev),
                torch.as_tensor(rng.normal(0, 1, (s, n)).astype(np.float32), device=dev),
                torch.as_tensor(rng.random((v, n)) < 0.9, device=dev),
                nbk, list(modes), list(vidx))
    if name == "topk":
        r, n, k, top = shape
        return (torch.as_tensor(rng.normal(0, 1, (r, n)).astype(np.float32), device=dev), k, top)
    if name == "join_probe":
        n, m, dtype = shape  # unique right keys 0 .. m-1, about 10% of left keys miss
        dt = getattr(torch, dtype)
        return (torch.as_tensor(rng.integers(0, m * 10 // 9, n), device=dev).to(dt),
                torch.arange(m, device=dev).to(dt))
    if name == "ssd_chunk_scan":
        bt, S, H, Pd, N, L, dtype = shape
        return ssd_inputs(torch, rng, dev, bt, S, H, Pd, N, getattr(torch, dtype)) + (L,)
    r, n, esize, shared, fill = shape
    dt = {1: torch.bool, 4: torch.int32, 8: torch.float64}[esize]
    return (torch.as_tensor(rng.normal(0, 1, (r, n)), device=dev).to(dt),
            torch.as_tensor(rng.random(n if shared else (r, n)) < 0.5, device=dev), fill)


def main_path_parity(torch, K, shapes, rng, dev):
    """Each kernel against its plain version at every distinct shape the main
    path (or the serving phase) gave it; returns (max |err|, number of
    shapes) per kernel."""
    out = {}
    for name in K:
        check(shapes[name], f"no main-path shape recorded for {name}")
        err = 0.0
        distinct = sorted(set(shapes[name]))
        if name == "ssd_chunk_scan":  # by route, each launch checked for its kernel
            errs = {n: 0.0 for n in SERVING}

            def note(n, e):
                errs[n] = max(errs[n], e)

            ssd_parity(torch, K, rng, dev, note, distinct)
            out.update({n: (e, len(distinct)) for n, e in errs.items()})
            continue
        for shape in distinct:
            args = main_path_inputs(torch, name, shape, rng, dev)
            label = f"main-path shape {shape}"
            err = max(err, segment_contracts(torch, K, rng, dev, args, label)
                      if name == "segment_reduce" else kernel_vs_plain(torch, K, name, args, label))
        out[name] = (err, len(distinct))
    return out


def timings(torch, K, shapes, rng, dev):
    """Kernel, plain version and library call at the largest shape the main
    path gave each kernel (its dominant cost), beside the card's bound."""
    flush = torch.empty(32 << 20, dtype=torch.float32, device=dev)
    sizes = {
        "masked_stats": lambda sh: sh[0] * sh[1],
        "segment_reduce": lambda sh: (sh[0], sh[1] + sh[2], sh[3]),
        "topk": lambda sh: (sh[0] * sh[1], sh[2]),
        "filter_compact": lambda sh: sh[0] * sh[1] * sh[2],
        "join_probe": lambda sh: (sh[0], sh[1]),
        "ssd_chunk_scan": lambda sh: (sh[0] * sh[1], sh[5]),
    }
    big = {name: max(shapes[name], key=sizes[name]) for name in DATAFRAME}
    args = {name: main_path_inputs(torch, name, big[name], rng, dev) for name in DATAFRAME}
    out = {}
    out["masked_stats"] = stats_timing(torch, K["masked_stats"], args["masked_stats"], flush)

    # segment_reduce: keys (n,), values (S, n), valids (V, n), B buckets; at
    # the largest shape, and at the largest with B = 100,000 (cell 7)
    def seg_row(shape, a):
        keys, vals, vm, nbk, _, _ = a
        n, s, v = shape[:3]

        def lib_seg():
            torch.zeros(nbk, device=dev).index_add_(
                0, keys, torch.where(vm[0], vals[0] if s else vm[0].float(), 0.0))

        return dict(
            shape=[n, s, v, nbk],
            ms=timed(torch, lambda: K["segment_reduce"].segment_reduce(*a), 10, flush),
            plain_ms=timed(torch, lambda: K["segment_reduce"].segment_reduce_plain(*a), 2, flush),
            library_ms=timed(torch, lib_seg, 10, flush),
            bound=bound(n * (4 + 4 * s + v) + (s + v) * nbk * 4, n * (s + v)),
        )

    out["segment_reduce"] = seg_row(big["segment_reduce"], args["segment_reduce"])
    wide = [sh for sh in shapes["segment_reduce"] if sh[3] == 100_000]
    check(wide, "no segment_reduce launch at B = 100,000 on the main path")
    wide = max(wide, key=sizes["segment_reduce"])
    out["segment_reduce B=100000"] = seg_row(
        wide, main_path_inputs(torch, "segment_reduce", wide, rng, dev))
    # the sort path at small B: the largest B = 1,000 main-path row count with
    # one sum row (value_counts itself has none)
    narrow = [sh for sh in shapes["segment_reduce"] if sh[3] == 1000]
    check(narrow, "no segment_reduce launch at B = 1,000 on the main path")
    narrow = (max(narrow, key=sizes["segment_reduce"])[0], 1, 1, 1000, ("sum",), (0,))
    out["segment_reduce B=1000 S=1"] = seg_row(
        narrow, main_path_inputs(torch, "segment_reduce", narrow, rng, dev))

    out["topk"] = topk_timing(torch, K["topk"], args["topk"], flush)

    out["filter_compact"] = compact_timing(torch, K["filter_compact"], args["filter_compact"],
                                           flush)

    out["join_probe"] = join_timing(torch, K["join_probe"], args["join_probe"], flush)

    # ssd_chunk_scan: the intra-chunk launch alone (the inter-chunk scan and
    # ssd_recur are kernels of their own, timed below); no library call.
    # Each intra-chunk kernel at the largest shape of its route on the
    # serving path, beside ssd_cells on the same inputs: ssd_wgmma at the
    # 1,024-token prefill's, ssd_short at the one-token-chunk prompt's (which
    # ssd_recur now serves).  The serving path launches ssd_short and
    # ssd_cells no time: the cells row is its time at the one-token-chunk
    # shape
    sc = K["ssd_chunk_scan"]
    for route in ("wgmma", "short"):
        mine = [sh for sh in shapes["ssd_chunk_scan"]
                if sc.ssd_route(getattr(torch, sh[6]), sh[5], sh[4], sh[3]) == route]
        check(mine, f"no ssd_chunk_scan launch on the {route} kernel on the serving path")
        sh = max(mine, key=sizes["ssd_chunk_scan"])
        out[f"ssd_chunk_scan_{route}"] = ssd_timing(
            torch, sc, sh, main_path_inputs(torch, "ssd_chunk_scan", sh, rng, dev), flush)
    short = out["ssd_chunk_scan_short"]
    out["ssd_chunk_scan_cells"] = dict(short, route="cells", ms=short["earlier_ms"])
    out["ssd_chunk_scan_inter"] = scan_timing(torch, sc, shapes["ssd_chunk_scan"], rng, dev,
                                              flush)
    out["ssd_chunk_scan_recur"] = recur_timing(torch, sc, shapes["ssd_chunk_scan"], rng, dev,
                                               flush)
    return out


def scan_timing(torch, mod, shapes, rng, dev, flush):
    """The inter-chunk scan at the serving path's two prompt shapes (the
    1,024-token prompt's chunks of 128, and the one-token-chunk prompt's,
    which ssd_recur now takes) (:func:`scan_row`).  → the row of the
    chunks of 128, with the other under ``L1``."""
    rows = {}
    for key, want_l in (("L1", 1), ("chunk128", 128)):
        mine = [sh for sh in shapes if sh[5] == want_l]
        check(mine, f"no ssd_chunk_scan launch at chunk {want_l} on the serving path")
        rows[key] = scan_row(torch, mod, max(mine, key=lambda sh: sh[0] * sh[1]), rng, dev,
                             flush)
    return dict(rows["chunk128"], L1=rows["L1"])


def scan_row(torch, mod, shape, rng, dev, flush):
    """The inter-chunk scan at ``shape`` (bt, S, H, P, N, L, dtype): the
    wrapper (the decays' torch ops, then one ssd_scan launch), its bare C
    entry on precomputed decays (h_final bit for bit the plain version's, y
    by check_ssd), the plain version (a loop over the chunks) and the
    bound → its timing row."""
    bt, S, H, Pd, N, L, dtype = shape
    x, la, b, c = ssd_inputs(torch, rng, dev, bt, S, H, Pd, N, getattr(torch, dtype))
    y_intra, state = mod.ssd_chunk_intra(x, la, b, c, L)
    ecum = mod.chunk_decays(la, S // L)
    y = torch.empty_like(y_intra)
    hf = torch.empty((bt, H, N, Pd), device=dev)
    tin = mod.DTYPES[x.dtype]
    stream = torch.cuda.current_stream().cuda_stream

    cpb = mod.scan_chunks(bt, S // L, H, Pd, L, torch.cuda.get_device_properties(
        dev).multi_processor_count)

    def c_entry():
        check(mod._fns()["scan"](y_intra.data_ptr(), state.data_ptr(), ecum.data_ptr(),
                                 c.data_ptr(), bt, S, H, Pd, N, L, cpb, tin, y.data_ptr(),
                                 hf.data_ptr(), stream) == 0,
              "ssd_scan C entry point")

    c_entry()
    want = mod.ssd_chunk_inter_plain(y_intra, state, la, c)
    check(torch.equal(hf, want[1]), f"ssd_scan C entry at {[bt, S, H, Pd, N, L]}: h_final "
          "differs from the plain version's")
    check_ssd(torch, (y, hf), want, "ssd_scan C entry at the timing shape")
    r = dict(
        shape=[bt, S, H, Pd, N, L, dtype],
        ms=timed(torch, lambda: mod.ssd_chunk_inter(y_intra, state, la, c), 10, flush),
        c_entry_ms=timed(torch, c_entry, 10, flush),
        plain_ms=timed(torch, lambda: mod.ssd_chunk_inter_plain(y_intra, state, la, c), 2,
                       flush),
        library_ms=None,
        bound=bound(*scan_work(bt, S, H, Pd, N, L, x.element_size())),
    )
    print(f"[time] inter-chunk scan at {r['shape']}: wrapper {r['ms']} ms, C entry alone "
          f"{r['c_entry_ms']} ms, plain {r['plain_ms']} ms, bound {r['bound'][0]} ms "
          f"({r['bound'][1]})", flush=True)
    return r


def ssd_shard_rows(torch, K, rng, dev, flush, errs):
    """The SSD kernels at one shard's heads of mamba2_2p7b's served prefill
    (TPT_SSD_SHARD, phase 4m's state placed by heads): ``ssd_chunk_scan``
    against its plain version there (``ssd_parity``: ssd_wgmma and
    ssd_scan launched once each; the errors noted into ``errs`` under the
    kernels' rows), then ssd_wgmma (beside ssd_cells on the same inputs)
    and ssd_scan timed beside their bounds → {label: timing row}."""
    sc = K["ssd_chunk_scan"]

    def note(name, e):
        errs[name] = max(errs[name], e)

    ssd_parity(torch, K, rng, dev, note, (TPT_SSD_SHARD,))
    args = main_path_inputs(torch, "ssd_chunk_scan", TPT_SSD_SHARD, rng, dev)
    return {"ssd_chunk_scan_wgmma tp4 shard": ssd_timing(torch, sc, TPT_SSD_SHARD, args, flush),
            "ssd_chunk_scan_inter tp4 shard": scan_row(torch, sc, TPT_SSD_SHARD, rng, dev,
                                                       flush)}


def recur_timing(torch, mod, shapes, rng, dev, flush):
    """ssd_recur at the serving path's one-token-chunk shape: the wrapper
    (the decays' torch ops, then one launch), its bare C entry on
    precomputed decays, the plain version (chunk 1), the bound, and the
    pair ssd_short + ssd_scan on the same inputs (wrappers, and C entries
    alone), the route these prompts took before ssd_recur."""
    mine = [sh for sh in shapes if mod.scan_route(sh[5], sh[4]) == "recur"]
    check(mine, "no ssd_chunk_scan launch on ssd_recur on the serving path")
    bt, S, H, Pd, N, L, dtype = max(mine, key=lambda sh: sh[0] * sh[1])
    x, la, b, c = ssd_inputs(torch, rng, dev, bt, S, H, Pd, N, getattr(torch, dtype))
    ecum = mod.chunk_decays(la, S)
    y = torch.empty_like(x)
    hf = torch.empty((bt, H, N, Pd), device=dev)
    y_intra = torch.empty_like(x)
    state = torch.empty((bt, S, H, N, Pd), device=dev)
    yp, hp = torch.empty_like(x), torch.empty_like(hf)
    tin = mod.DTYPES[x.dtype]
    stream = torch.cuda.current_stream().cuda_stream
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    fns = mod._fns()

    def c_entry():
        check(fns["recur"](x.data_ptr(), ecum.data_ptr(), b.data_ptr(), c.data_ptr(), bt, S, H,
                           Pd, N, tin, y.data_ptr(), hf.data_ptr(), stream) == 0,
              "ssd_recur C entry point")

    def pair_entries():
        check(fns["short"](x.data_ptr(), la.data_ptr(), b.data_ptr(), c.data_ptr(), bt, S, H, Pd,
                           N, 1, tin, mod.short_heads(bt, S, H, 1, N, Pd, sms),
                           y_intra.data_ptr(), state.data_ptr(), stream) == 0,
              "ssd_short C entry point")
        check(fns["scan"](y_intra.data_ptr(), state.data_ptr(), ecum.data_ptr(), c.data_ptr(),
                          bt, S, H, Pd, N, 1, mod.scan_chunks(bt, S, H, Pd, 1, sms), tin,
                          yp.data_ptr(), hp.data_ptr(), stream) == 0,
              "ssd_scan C entry point")

    c_entry()
    pair_entries()
    want = mod.ssd_chunk_scan_plain(x, la, b, c, 1)
    for got, label in (((y, hf), "ssd_recur C entry"), ((yp, hp), "ssd_short + ssd_scan")):
        check(torch.equal(got[1], want[1]), f"{label} at {[bt, S, H, Pd, N]}: h_final differs "
              "from the plain version's")
        check_ssd(torch, got, want, f"{label} at the timing shape")
    row = dict(
        shape=[bt, S, H, Pd, N, L, dtype],
        ms=timed(torch, lambda: mod.ssd_chunk_recur(x, la, b, c), 20, flush),
        c_entry_ms=timed(torch, c_entry, 20, flush),
        pair_ms=timed(torch, lambda: mod.ssd_chunk_inter(
            *mod.ssd_chunk_intra(x, la, b, c, 1), la, c), 10, flush),
        pair_c_entries_ms=timed(torch, pair_entries, 10, flush),
        plain_ms=timed(torch, lambda: mod.ssd_chunk_scan_plain(x, la, b, c, 1), 2, flush),
        library_ms=None,
        bound=bound(*recur_work(bt, S, H, Pd, N, x.element_size())),
    )
    print(f"[time] ssd_recur at {row['shape']}: wrapper {row['ms']} ms, C entry alone "
          f"{row['c_entry_ms']} ms; ssd_short + ssd_scan on the same inputs: wrappers "
          f"{row['pair_ms']} ms, C entries alone {row['pair_c_entries_ms']} ms; plain "
          f"{row['plain_ms']} ms, bound {row['bound'][0]} ms ({row['bound'][1]})", flush=True)
    return row


def ssd_timing(torch, mod, shape, args, flush):
    """The intra-chunk launch at ``shape``: the wrapper (on the kernel
    ``ssd_route`` names, ssd_wgmma or ssd_short), ``ssd_cells`` through its
    C entry point on the same inputs (the earlier kernel), the plain version
    and the bound."""
    x, la, b, c, L = args
    bt, S, H, Pd, N = shape[:5]
    route = mod.ssd_route(x.dtype, L, N, Pd)
    check(route != "cells", f"ssd_timing: {shape} is on ssd_cells itself")
    row = dict(
        shape=[bt, S, H, Pd, N, L, str(x.dtype)], route=route,
        ms=timed(torch, lambda: mod.ssd_chunk_intra(x, la, b, c, L), 20, flush),
        plain_ms=timed(torch, lambda: mod.ssd_chunk_intra_plain(x, la, b, c, L), 5, flush),
        library_ms=None,
        bound=bound(*ssd_work(bt, S, H, Pd, N, L, x.element_size()),
                    BF16_OPS_PER_S if x.dtype == torch.bfloat16 else F32_OPS_PER_S),
    )
    y, st = torch.empty_like(x), torch.empty((bt, S // L, H, N, Pd), device=x.device)
    stream = torch.cuda.current_stream().cuda_stream

    def cells():
        err = mod._fns()["cells"](x.data_ptr(), la.data_ptr(), b.data_ptr(), c.data_ptr(),
                                  bt, S, H, Pd, N, L, mod.DTYPES[x.dtype], y.data_ptr(),
                                  st.data_ptr(), stream)
        check(err == 0, f"ssd_cells failed with cudaError_t {err}")

    cells()
    check_ssd(torch, (y, st), mod.ssd_chunk_intra_plain(x, la, b, c, L),
              "ssd_cells at the timing shape")
    row["earlier_ms"] = timed(torch, cells, 20, flush)
    print(f"[time] ssd_chunk_scan detail at {row['shape']} ({route}): kernel {row['ms']} ms, "
          f"ssd_cells on the same inputs {row['earlier_ms']} ms, plain "
          f"{row['plain_ms']} ms, bound {row['bound'][0]} ms", flush=True)
    return row


def ssd_bwd_timing(torch, rng, dev):
    """The SSD backward at mamba2_2p7b's training launch (1 x 4,096 x 80 x 64,
    N 128, chunk 128, bf16, no dh): each kernel through its C entry on the
    same buffers (mean cold-L2 ms): the tensor-core route's state and chunk
    kernels, and beside them the float32 FMA kernels of the same function
    (``earlier_ms``), then ``ssd_bwd_sum``; the wrapper (all three launches
    and their allocations), the plain backward, and each kernel's bound from
    ``ssd_bwd_work`` at the bf16 peak (bf16 inputs, as ``ssd_timing``) with
    the float32 peak's beside it, and the whole gradient's bound
    (``ssd_bwd_total``: its inputs and outputs alone, no scratch) beside
    the three launches'.  No single PyTorch call computes this
    gradient: library none.  → {row of SSD_BWD_ROWS: row}: the FMA kernels'
    rows carry their own times, the tensor-core rows theirs with the FMA
    kernel's as ``earlier_ms``."""
    from repro_torch.kernels import ssd_chunk as sc

    flush = torch.empty(32 << 20, dtype=torch.float32, device=dev)
    bt, S, H, Pd, N, L = 1, SSD_SEQ, 80, 64, 128, 128
    x, la, b, c, dy, _ = ssd_bwd_inputs(torch, rng, dev, bt, S, H, Pd, N, torch.bfloat16, False,
                                        False)
    check(sc.bwd_route(x.dtype, L, N, Pd) == "wgmma", "the training launch is not on the "
          "tensor-core route")
    nc, code = S // L, sc.DTYPES[x.dtype]
    G = sc.heads_per_block(bt, nc, H, sc._sm_count(dev.index or 0))
    hin = torch.empty((bt, nc, H, N, Pd), device=dev)
    g = torch.empty_like(hin)
    dbp = torch.empty((bt, nc, H, L, N), device=dev)
    dcp = torch.empty_like(dbp)
    dx, dla = torch.empty_like(x), torch.empty((bt, S, H), device=dev)
    db, dc = torch.empty_like(b), torch.empty_like(c)
    fns, stream, shape = sc._bwd_fns(), torch.cuda.current_stream().cuda_stream, (bt, S, H, Pd,
                                                                                   N, L)
    ins = (x.data_ptr(), la.data_ptr(), b.data_ptr(), c.data_ptr(), dy.data_ptr())
    outs = (dx.data_ptr(), dla.data_ptr(), dbp.data_ptr(), dcp.data_ptr(), stream)
    entries = {
        "ssd_chunk_scan_bwd_state_wgmma": lambda: fns["state_wgmma"](
            *ins, 0, *shape, hin.data_ptr(), g.data_ptr(), stream),
        "ssd_chunk_scan_bwd_chunk_wgmma": lambda: fns["chunk_wgmma"](
            *ins, hin.data_ptr(), g.data_ptr(), *shape, G, *outs),
        "ssd_chunk_scan_bwd_sum": lambda: fns["sum"](
            dbp.data_ptr(), dcp.data_ptr(), bt, S, H, N, L, code, db.data_ptr(), dc.data_ptr(),
            stream),
    }
    earlier = {
        "ssd_chunk_scan_bwd_state": lambda: fns["state"](
            *ins, 0, *shape, code, hin.data_ptr(), g.data_ptr(), stream),
        "ssd_chunk_scan_bwd_chunk": lambda: fns["chunk"](
            *ins, hin.data_ptr(), g.data_ptr(), *shape, code, *outs),
    }
    for name, fn in entries.items():
        check(fn() == 0, f"{name} C entry point")
    want = sc.ssd_chunk_scan_bwd(x, la, b, c, L, dy)
    check(all(torch.equal(p, q) for p, q in zip((dx, dla, db, dc), want)),
          "the SSD backward's C entries differ from its wrapper")
    work = ssd_bwd_work(bt, S, H, Pd, N, L, x.element_size(), False)
    wrapper_ms = timed(torch, lambda: sc.ssd_chunk_scan_bwd(x, la, b, c, L, dy), 10, flush)
    plain_ms = timed(torch, lambda: sc.ssd_chunk_scan_bwd_plain(x, la, b, c, L, dy), 3, flush)

    def ms(name, fn, iters):
        return timed(torch, lambda: check(fn() == 0, name), iters, flush)

    def row(kernel, t, earlier_ms=None):
        return dict(shape=[bt, S, H, Pd, N, L, "bfloat16"], ms=t, earlier_ms=earlier_ms,
                    plain_ms=plain_ms, library_ms=None,
                    bound=bound(*work[kernel], BF16_OPS_PER_S),
                    bound_f32=bound(*work[kernel], F32_OPS_PER_S))

    fma = {name: ms(name, fn, 5) for name, fn in earlier.items()}
    rows = {name: row(name, t) for name, t in fma.items()}
    for name, fn in entries.items():
        kernel = name.replace("_wgmma", "")
        rows[name] = row(kernel, ms(name, fn, 10), fma.get(kernel))
    total = bound(sum(w[0] for w in work.values()), sum(w[1] for w in work.values()),
                  BF16_OPS_PER_S)
    whole = bound(*ssd_bwd_total(bt, S, H, Pd, N, L, x.element_size(), False), BF16_OPS_PER_S)
    print(f"[time] ssd backward at {rows[SSD_BWD[0]]['shape']}: wrapper (three launches) "
          f"{wrapper_ms} ms, plain backward {plain_ms} ms, bound of the three launches' own "
          f"work {total[0]} ms ({total[1]}, bf16 peak; h_in, g and the heads' db and dc terms "
          f"written and read again), bound of the gradient {whole[0]} ms ({whole[1]}: x, dy, "
          f"b, c and log_a read, dx, dlog_a, db and dc written, no scratch); C entries alone "
          f"({G} heads a chunk block): " + json.dumps(
              {k: {"ms": r["ms"], "earlier_ms": r["earlier_ms"], "bound_ms": r["bound"][0],
                   "bound_by": r["bound"][1], "bound_f32_ms": r["bound_f32"][0]}
               for k, r in rows.items()}), flush=True)
    return rows


# the device functions of csrc/filter_compact.cu, csrc/masked_stats.cu and
# csrc/topk.cu, for the profiler's split
COMPACT_KERNELS = ("tile_counts", "scatter_tiles")
STATS_KERNELS = ("stats_tiles", "stats_merge")
TOPK_KERNELS = ("topk_spans", "topk_merge")


def kernel_split(torch, fn, names, iters, flush):
    """Device ms a launch of each kernel named in ``names`` takes: the mean
    over the launches torch.profiler recorded in ``iters`` calls of ``fn``,
    each after an L2 flush.  Dividing by the launches recorded, not by
    ``iters``, keeps a trace that drops events from reading short; a trace
    that recorded no launch of a named kernel (one in four runs of
    topk's, on an H100) is taken again, three traces at most."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
        dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        mine = {name: [e for e in dev if name in e.key] for name in names}
        missing = [name for name in names if not sum(e.count for e in mine[name])]
        if not missing:
            break
        print(f"[time] kernel_split: trace {attempt + 1} recorded no launch of {missing}",
              flush=True)
    check(not missing, f"kernel_split: no launch of {missing} in three traces")
    return {name: sum(e.self_device_time_total for e in es) / 1e3 / sum(e.count for e in es)
            for name, es in mine.items()}


def compact_timing(torch, fc, args, flush):
    """filter_compact at the largest main-path shape: the wrapper, its bare C
    entry point on preallocated outputs and scratch (the wrapper's host work
    left out), each of its kernels' device time a call, the plain version,
    ``torch.masked_select`` and the bound (data read and written once, the
    mask read once)."""
    xs, keep, fill = args
    r, n = xs.shape
    size = xs.element_size()
    keep_rows = 1 if keep.dim() == 1 else r
    out = torch.empty_like(xs)
    scratch = torch.empty(fc.scratch_size(keep_rows, n), dtype=torch.int64, device=xs.device)
    totals = scratch[:keep_rows]
    stream = torch.cuda.current_stream().cuda_stream
    bits = fc._fill_bits(fill, xs.dtype, size)

    def c_entry():
        check(fc._fn()(xs.data_ptr(), out.data_ptr(), keep.data_ptr(), keep_rows, r, n, size,
                       bits, scratch.data_ptr(), stream) == 0, "filter_compact C entry point")

    c_entry()
    check_compact(torch, (out, totals.expand(r) if keep_rows == 1 else totals),
                  fc.filter_compact_plain(xs, keep, fill), "C entry point, timing inputs")
    row = dict(
        shape=[r, n, size],
        ms=timed(torch, lambda: fc.filter_compact(xs, keep, fill), 20, flush),
        bare_ms=timed(torch, c_entry, 20, flush),
        split=kernel_split(torch, c_entry, COMPACT_KERNELS, 20, flush),
        plain_ms=timed(torch, lambda: fc.filter_compact_plain(xs, keep, fill), 3, flush),
        library_ms=timed(torch, lambda: torch.masked_select(xs, keep), 20, flush),
        bound=bound(r * n * size * 2 + keep_rows * n, 0),
    )
    print(f"[time] filter_compact detail at {row['shape']}: wrapper {row['ms']} ms, C entry "
          f"alone {row['bare_ms']} ms, device ms a call by kernel {json.dumps(row['split'])}, "
          f"torch.masked_select {row['library_ms']} ms", flush=True)
    return row


def stats_timing(torch, mod, args, flush):
    """masked_stats at the largest main-path shape: the wrapper, its bare C
    entry point on a preallocated buffer (the wrapper's host work left out),
    each of its kernels' device time a call, the plain version, ``var_mean``
    + ``aminmax`` over each row's valid values, and the bound (values and
    mask read once, the rows of five written once)."""
    xs, ms = args
    r, n = xs.shape
    size, head = mod.buffer_rows(r, n)
    buf = torch.empty((size, 5), dtype=torch.float32, device=xs.device)
    stream = torch.cuda.current_stream().cuda_stream

    def c_entry():
        check(mod._fn()(xs.data_ptr(), ms.data_ptr(), r, n, buf.data_ptr() + 20 * head,
                        buf.data_ptr(), stream) == 0, "masked_stats C entry point")

    def lib_stats():
        for i in range(r):
            v = xs[i][ms[i]]
            torch.var_mean(v)
            torch.aminmax(v)

    c_entry()
    check_stats(torch, buf[:r], mod.masked_stats_plain(xs, ms), xs, ms,
                "C entry point, timing inputs")
    row = dict(
        shape=[r, n],
        ms=timed(torch, lambda: mod.masked_stats(xs, ms), 20, flush),
        bare_ms=timed(torch, c_entry, 20, flush),
        split=kernel_split(torch, c_entry, STATS_KERNELS, 20, flush),
        plain_ms=timed(torch, lambda: mod.masked_stats_plain(xs, ms), 3, flush),
        library_ms=timed(torch, lib_stats, 5, flush),
        bound=bound(r * n * 5 + r * 20, 8 * int(ms.sum())),
    )
    print(f"[time] masked_stats detail at {row['shape']}: wrapper {row['ms']} ms, C entry "
          f"alone {row['bare_ms']} ms, device ms a call by kernel {json.dumps(row['split'])}, "
          f"var_mean + aminmax {row['library_ms']} ms", flush=True)
    return row


def topk_timing(torch, mod, args, flush):
    """topk at the largest main-path shape: the wrapper, its bare C entry
    point on a preallocated buffer, each of its kernels' device time a call,
    the plain version, ``torch.topk`` and the bound (the rows read once, k
    values a row written once); then the wrapper and ``torch.topk`` on the
    same rows sorted the worst way for a running threshold (ascending when
    the largest are kept)."""
    xs, k, largest = args
    r, n = xs.shape
    blocks, size = mod.buffer_rows(r, n)
    buf = torch.empty((size, k), dtype=torch.float32, device=xs.device)
    stream = torch.cuda.current_stream().cuda_stream
    sign = 1.0 if largest else -1.0

    def c_entry():
        check(mod._fn()(xs.data_ptr(), r, n, k, blocks, sign, buf.data_ptr() + 4 * r * k,
                        buf.data_ptr(), stream) == 0, "topk C entry point")

    c_entry()
    check_topk(torch, buf[:r], mod.topk_plain(xs, k, largest),
               "C entry point, timing inputs")
    row = dict(
        shape=[r, n, k],
        ms=timed(torch, lambda: mod.topk(xs, k, largest), 20, flush),
        bare_ms=timed(torch, c_entry, 20, flush),
        split=kernel_split(torch, c_entry, TOPK_KERNELS, 20, flush),
        plain_ms=timed(torch, lambda: mod.topk_plain(xs, k, largest), 3, flush),
        library_ms=timed(torch, lambda: torch.topk(xs, k, dim=-1, largest=largest), 20, flush),
        bound=bound(r * n * 4 + r * k * 4, r * n),
    )
    asc = torch.sort(xs, dim=-1, descending=not largest).values
    check_topk(torch, mod.topk(asc, k, largest), mod.topk_plain(asc, k, largest),
               "sorted row, timing shape")
    row["sorted_ms"] = timed(torch, lambda: mod.topk(asc, k, largest), 20, flush)
    row["sorted_library_ms"] = timed(
        torch, lambda: torch.topk(asc, k, dim=-1, largest=largest), 20, flush)
    print(f"[time] topk detail at {row['shape']} ({blocks} blocks a row): wrapper {row['ms']} "
          f"ms, C entry alone {row['bare_ms']} ms, device ms a call by kernel "
          f"{json.dumps(row['split'])}, torch.topk {row['library_ms']} ms", flush=True)
    print(f"[time] topk on a row sorted the worst way (ascending when the largest are kept) "
          f"at {row['shape']}: wrapper {row['sorted_ms']} ms, torch.topk "
          f"{row['sorted_library_ms']} ms", flush=True)
    return row


def join_timing(torch, jp, args, flush):
    """join_probe at the largest main-path shape: the wrapper, its bare C
    entry point on preallocated outputs (the wrapper's host work left out),
    the same left keys against the first 20,000 right keys (staged whole:
    the search never leaves shared memory), the plain version,
    ``torch.searchsorted`` and the bound (the search does ceil(log2(m + 1))
    comparisons a key)."""
    import math

    lk, rk = args
    n, m = lk.shape[0], rk.shape[0]
    size = lk.element_size()
    k = jp.sample_log2(m, size)
    scratch = torch.empty(0 if k == 0 else -(-m >> k) * size, dtype=torch.uint8, device=lk.device)
    pos = torch.empty(n, dtype=torch.int32, device=lk.device)
    hit = torch.empty(n, dtype=torch.bool, device=lk.device)
    stream = torch.cuda.current_stream().cuda_stream
    bare = jp._fns()

    def c_entry():
        check(bare(lk.data_ptr(), n, rk.data_ptr(), m, jp.DTYPES[lk.dtype], k,
                   scratch.data_ptr(), scratch.numel(), pos.data_ptr(), hit.data_ptr(),
                   stream) == 0, "join_probe C entry point")

    want = jp.join_probe_plain(lk, rk)
    c_entry()
    check_join(torch, (pos, hit), want, "C entry point, timing inputs")
    row = dict(
        shape=[n, m, str(lk.dtype)],
        ms=timed(torch, lambda: jp.join_probe(lk, rk), 20, flush),
        bare_ms=timed(torch, c_entry, 20, flush),
        staged_ms=timed(torch, lambda: jp.join_probe(lk, rk[:20_000]), 20, flush),
        plain_ms=timed(torch, lambda: jp.join_probe_plain(lk, rk), 5, flush),
        library_ms=timed(torch, lambda: torch.searchsorted(rk, lk), 20, flush),
        bound=bound(n * (size + 4 + 1) + m * rk.element_size(),
                    n * math.ceil(math.log2(m + 1))),
    )
    print(f"[time] join_probe detail at {row['shape']} (sample step 2^{k}): wrapper {row['ms']} "
          f"ms, C entry alone {row['bare_ms']} ms, against 20,000 right keys staged whole "
          f"{row['staged_ms']} ms, torch.searchsorted {row['library_ms']} ms", flush=True)
    return row


# the attention shape of one training microbatch of smollm_360m at 4,096
# tokens: B 4 x Hq 15 (Hkv 5) x 4,096 x 64, bf16, causal
TRAIN_ATTN = (4, 15, 5, 4096, 4096, 64, "bfloat16", True, None, 0)
# the forward also at qwen3_8b's heads (32 / 8 x 128), one sequence of 4,096
WIDE_ATTN = (1, 32, 8, 4096, 4096, 128, "bfloat16", True, None, 0)
# phase 4h (b)'s launches are WIDE_ATTN's (one sequence a row); its four
# rows' sequences side by side:
QWEN4_ATTN = (4, 32, 8, 4096, 4096, 128, "bfloat16", True, None, 0)
# phase 4e's shape: recurrentgemma_9b's local attention, one sequence of
# 4,096 tokens, 16 q-heads over one kv head of 256, window 2,048
RG_ATTN = (1, 16, 1, 4096, 4096, 256, "bfloat16", True, 2048, 0)
# phase 4f's shape: one microbatch of granite_moe_3b_a800m, 4 x 24 q-heads
# (8 kv heads) x 4,096 x 64, bf16, causal
MOE_ATTN = (4, 24, 8, 4096, 4096, 64, "bfloat16", True, None, 0)
# phase 4k's training shapes, one sequence each: musicgen_large (MHA, 32 x
# 64), h2o_danube_3_4b (D 120, window 4,096), starcoder2_7b (group 9),
# qwen3_moe_30b_a3b (32 / 4 x 128) and internvl2_76b (64 / 8 x 128 over 256
# patch embeddings + 4,096 tokens)
REG_ATTN = {
    "musicgen_large": (1, 32, 32, 4096, 4096, 64, "bfloat16", True, None, 0),
    "h2o_danube_3_4b": (1, 32, 8, 4096, 4096, 120, "bfloat16", True, 4096, 0),
    "starcoder2_7b": (1, 36, 4, 4096, 4096, 128, "bfloat16", True, None, 0),
    "qwen3_moe_30b_a3b": (1, 32, 4, 4096, 4096, 128, "bfloat16", True, None, 0),
    "internvl2_76b": (1, 64, 8, 4352, 4352, 128, "bfloat16", True, None, 0),
}


def sdpa_call(torch, fa, q, k, v, causal, window, off):
    """``scaled_dot_product_attention`` of the same function (the library
    yardstick): a boolean mask only where a window that cuts a key or a
    causal offset makes one, since a mask keeps the library off its flash
    path.  A window of at least Sq + off cuts nothing."""
    import torch.nn.functional as F

    cuts = window is not None and window < q.shape[2] + off
    if not cuts and (off == 0 or not causal):
        return F.scaled_dot_product_attention(q, k, v, is_causal=causal, enable_gqa=True)
    mask = fa._mask(q.shape[2], k.shape[2], causal, window, off, q.device)
    return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, enable_gqa=True)


def forward_timing(torch, rng, dev, shape, flush):
    """The forward (through ``flash_forward``, on the kernel its route
    names), the plain forward and SDPA's forward at ``shape``, in ms, and
    the forward's bound."""
    from repro_torch.kernels import flash_attention as fa

    B, Hq, Hkv, Sq, Skv, D, dtype, causal, window, off = shape
    q, k, v, _ = attn_inputs(torch, rng, dev, B, Hq, Hkv, Sq, Skv, D, dtype)
    mask = (causal, window, None, off)
    return dict(
        shape=[B, Hq, Hkv, Sq, Skv, D, dtype, "causal" if causal else "full"],
        ms=timed(torch, lambda: fa.flash_forward(q, k, v, *mask), 10, flush),
        plain_ms=timed(torch, lambda: fa.flash_attention_plain(q, k, v, *mask), 3, flush),
        library_ms=timed(torch, lambda: sdpa_call(torch, fa, q, k, v, causal, window, off), 10,
                         flush),
        bound=bound(*attention_work(shape)["flash_attention"], BF16_OPS_PER_S))


def backward_timing(torch, rng, dev, shape, flush, fma=False):
    """dQ and dK/dV (through ``backward_dq`` and ``backward_dkdv``, on the
    kernels their route names), the plain backward and SDPA's backward (all
    three gradients, one backward of a graph kept from one forward) at
    ``shape``, in ms, with each kernel's bound; ``fma`` also times the FMA
    kernels on the same bf16 inputs through their C entry points (the
    wrappers send bf16 at these widths to the tensor cores).  Returns (rows
    by kernel name, the ms printed)."""
    from repro_torch.kernels import flash_attention as fa

    B, Hq, Hkv, Sq, Skv, D, dtype, causal, window, off = shape
    q, k, v, g = attn_inputs(torch, rng, dev, B, Hq, Hkv, Sq, Skv, D, dtype)
    mask = (causal, window, None, off)
    _, o32, lse = fa.flash_forward(q, k, v, *mask, keep_f32=True)
    _, delta = fa.backward_dq(q, k, v, o32, lse, g, *mask)

    def backward_of(fn):
        qq, kk, vv = (x.detach().requires_grad_(True) for x in (q, k, v))
        out = fn(qq, kk, vv)
        return lambda: torch.autograd.grad(out, (qq, kk, vv), g, retain_graph=True)

    ms = {
        "kernel dq": timed(torch, lambda: fa.backward_dq(q, k, v, o32, lse, g, *mask), 10, flush),
        "kernel dkdv": timed(torch, lambda: fa.backward_dkdv(q, k, v, lse, delta, g, *mask),
                             10, flush),
        "plain bwd": timed(torch, backward_of(
            lambda qq, kk, vv: fa.flash_attention_plain(qq, kk, vv, *mask)), 3, flush),
        "sdpa bwd": timed(torch, backward_of(lambda qq, kk, vv: sdpa_call(
            torch, fa, qq, kk, vv, causal, window, off)), 10, flush),
    }
    if fma:
        args = fa._mask_args(q, k, causal, window, None, off)
        out = [torch.empty_like(t) for t in (delta, q, k, v)]
        st = torch.cuda.current_stream().cuda_stream

        def fma_dq():
            err = fa._fns()[1](q.data_ptr(), k.data_ptr(), v.data_ptr(), o32.data_ptr(),
                               g.data_ptr(), lse.data_ptr(), *args, out[0].data_ptr(),
                               out[1].data_ptr(), st)
            check(err == 0, f"the FMA dQ kernel failed with cudaError_t {err}")

        def fma_dkdv():
            err = fa._fns()[2](q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
                               lse.data_ptr(), delta.data_ptr(), *args, out[2].data_ptr(),
                               out[3].data_ptr(), st)
            check(err == 0, f"the FMA dK/dV kernel failed with cudaError_t {err}")

        ms["fma dq"] = timed(torch, fma_dq, 3, flush)
        ms["fma dkdv"] = timed(torch, fma_dkdv, 3, flush)
    work = attention_work(shape)
    row = dict(shape=[B, Hq, Hkv, Sq, Skv, D, dtype, "causal" if causal else "full"],
               plain_ms=ms["plain bwd"], library_ms=ms["sdpa bwd"])
    return {name: dict(row, ms=ms[f"kernel {which}"], bound=bound(*work[name], BF16_OPS_PER_S))
            for name, which in (("flash_attention_bwd_dq", "dq"),
                                ("flash_attention_bwd_dkdv", "dkdv"))}, ms


def attention_timings(torch, rng, dev):
    """The kernels, the plain version and SDPA at the training shape: mean
    of cold-L2 calls.  The forward row serves both ``flash_attention`` and
    ``flash_attention_wgmma``, each backward row its FMA and its tensor-core
    name (bf16 takes the tensor-core kernels); forward and backward also at
    WIDE_ATTN."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    B, Hq, Hkv, Sq, Skv, D, dtype, causal, window, off = TRAIN_ATTN
    q, k, v, g = attn_inputs(torch, rng, dev, B, Hq, Hkv, Sq, Skv, D, dtype)
    mask = (causal, window, None, off)
    flush = torch.empty(32 << 20, dtype=torch.float32, device=dev)

    def fwd_bwd(fn):
        def run():
            qq, kk, vv = (x.detach().requires_grad_(True) for x in (q, k, v))
            return torch.autograd.grad(fn(qq, kk, vv), (qq, kk, vv), g)
        return run

    def sdpa(qq, kk, vv):
        return F.scaled_dot_product_attention(qq, kk, vv, is_causal=True, enable_gqa=True)

    check(fa.forward_route(q.dtype, D) == "wgmma" and fa.backward_route(q.dtype, D) == "wgmma",
          "the training shape is not on the wgmma route")
    fwd = forward_timing(torch, rng, dev, TRAIN_ATTN, flush)
    bwd, ms = backward_timing(torch, rng, dev, TRAIN_ATTN, flush, fma=True)
    ms["kernel fwd"], ms["plain fwd"], ms["sdpa fwd"] = (
        fwd["ms"], fwd["plain_ms"], fwd["library_ms"])
    ms["kernel fwd+bwd"] = timed(torch, fwd_bwd(
        lambda qq, kk, vv: fa.flash_attention(qq, kk, vv, *mask)), 5, flush)
    ms["sdpa fwd+bwd"] = timed(torch, fwd_bwd(sdpa), 10, flush)
    print("[time] attention at the training shape " + json.dumps(TRAIN_ATTN) + ", ms: "
          + json.dumps(ms), flush=True)
    wide, wide_ms = backward_timing(torch, rng, dev, WIDE_ATTN, flush)
    print("[time] attention backward at " + json.dumps(WIDE_ATTN) + ", ms: "
          + json.dumps(wide_ms), flush=True)
    out = {"flash_attention": fwd, "flash_attention_wgmma": fwd,
           "flash_attention D=128": forward_timing(torch, rng, dev, WIDE_ATTN, flush)}
    # phase 4e's shape (D 256): the forward and both backward kernels beside
    # the plain version, SDPA and its backward, and their bounds
    check(fa.forward_route(torch.bfloat16, 256) == "wgmma", "D 256 is not on the wgmma route")
    out["flash_attention D=256"] = forward_timing(torch, rng, dev, RG_ATTN, flush)
    rg, rg_ms = backward_timing(torch, rng, dev, RG_ATTN, flush)
    print("[time] attention at phase 4e's shape " + json.dumps(RG_ATTN) + ", ms: "
          + json.dumps(dict(rg_ms, **{"kernel fwd": out["flash_attention D=256"]["ms"]})),
          flush=True)
    # phase 4f's shape: 24 q-heads over 8 kv heads
    out["flash_attention 24/8 heads"] = forward_timing(torch, rng, dev, MOE_ATTN, flush)
    moe_rows, moe_ms = backward_timing(torch, rng, dev, MOE_ATTN, flush)
    print("[time] attention at phase 4f's shape " + json.dumps(MOE_ATTN) + ", ms: "
          + json.dumps(dict(moe_ms, **{"kernel fwd": out["flash_attention 24/8 heads"]["ms"],
                                       "sdpa fwd": out["flash_attention 24/8 heads"][
                                           "library_ms"]})), flush=True)
    # phase 4h's heads (qwen3_8b, D 128) at four sequences
    out["flash_attention 4h"] = forward_timing(torch, rng, dev, QWEN4_ATTN, flush)
    q4_rows, q4_ms = backward_timing(torch, rng, dev, QWEN4_ATTN, flush)
    print("[time] attention at phase 4h's heads, four sequences " + json.dumps(QWEN4_ATTN)
          + ", ms: " + json.dumps(dict(q4_ms, **{
              "kernel fwd": out["flash_attention 4h"]["ms"],
              "sdpa fwd": out["flash_attention 4h"]["library_ms"],
              "bound fwd": out["flash_attention 4h"]["bound"][0],
              "bound dq": q4_rows["flash_attention_bwd_dq"]["bound"][0],
              "bound dkdv": q4_rows["flash_attention_bwd_dkdv"]["bound"][0]})), flush=True)
    for name in bwd:
        out[name] = out[name + "_wgmma"] = bwd[name]
        out[name + " 4h"] = q4_rows[name]
        out[name + " D=128"] = wide[name]
        out[name + " D=256"] = rg[name]
        out[name + " 24/8 heads"] = moe_rows[name]
    out.update(reg_attention_timings(torch, rng, dev, flush))
    return out


def reg_attention_timings(torch, rng, dev, flush, shapes=REG_ATTN, phase="4k"):
    """Phase 4k's training shapes (REG_ATTN; or ``phase``'s ``shapes``): the
    forward, dQ and dK/dV beside their bounds, SDPA (unmasked: danube's
    window of 4,096 cuts no key at S 4,096, ``sdpa_call``) and the plain
    version, by row name ("flash_attention <model>", ...)."""
    out = {}
    for model, shape in shapes.items():
        fwd_k = forward_timing(torch, rng, dev, shape, flush)
        rows, k_ms = backward_timing(torch, rng, dev, shape, flush)
        out[f"flash_attention {model}"] = fwd_k
        for name in rows:
            out[f"{name} {model}"] = rows[name]
        print(f"[time] attention at phase {phase}'s {model} shape " + json.dumps(shape) + ", ms: "
              + json.dumps(dict(k_ms, **{
                  "kernel fwd": fwd_k["ms"], "plain fwd": fwd_k["plain_ms"],
                  "sdpa fwd": fwd_k["library_ms"], "bound fwd": fwd_k["bound"][0],
                  "bound dq": rows["flash_attention_bwd_dq"]["bound"][0],
                  "bound dkdv": rows["flash_attention_bwd_dkdv"]["bound"][0]})), flush=True)
    return out


def recorder(K):
    """Context manager that records the shapes each kernel wrapper of ``K``
    is given (calls pass straight through, so launch counts are the
    wrappers' own)."""
    from contextlib import contextmanager

    shapes = {name: [] for name in K}
    originals = {name: getattr(K[name], name) for name in K}

    def ms(xs, m):
        shapes["masked_stats"].append(tuple(xs.shape))
        return originals["masked_stats"](xs, m)

    def sr(keys, values, valids, nb, modes, vidx):
        shapes["segment_reduce"].append(
            (keys.shape[0], values.shape[0], valids.shape[0], int(nb), tuple(modes),
             tuple(int(i) for i in vidx)))
        return originals["segment_reduce"](keys, values, valids, nb, modes, vidx)

    def tk(xs, k, largest=True):
        shapes["topk"].append((xs.shape[0], xs.shape[1], int(k), bool(largest)))
        return originals["topk"](xs, k, largest)

    def fc(xs, keep, fill=0):
        shapes["filter_compact"].append(
            (xs.shape[0], xs.shape[1], xs.element_size(), keep.dim() == 1, fill))
        return originals["filter_compact"](xs, keep, fill)

    def jp(lk, rk):
        shapes["join_probe"].append((lk.shape[0], rk.shape[0], str(lk.dtype).split(".")[1]))
        return originals["join_probe"](lk, rk)

    def sc(x, log_a, b, c, chunk):
        shapes["ssd_chunk_scan"].append(
            (*x.shape, b.shape[-1], int(chunk), str(x.dtype).split(".")[1]))
        return originals["ssd_chunk_scan"](x, log_a, b, c, chunk)

    wrapped = {name: fn for name, fn in (
        ("masked_stats", ms), ("segment_reduce", sr), ("topk", tk), ("filter_compact", fc),
        ("join_probe", jp), ("ssd_chunk_scan", sc)) if name in K}

    @contextmanager
    def record():
        for name, fn in wrapped.items():
            setattr(K[name], name, fn)
        try:
            yield
        finally:
            for name, fn in originals.items():
                setattr(K[name], name, fn)

    return shapes, record


# --------------------------------------------------------------------------- #
# phase 4b: opportunistic serving of mamba2_2p7b at full width                  #
# --------------------------------------------------------------------------- #

SERVE_SEED = 12
N_TOKENS = 16
# decode steps a profiled decode runs: the profiler's reading of 16 steps of
# a 32-layer model took 69 s on the card's host (a 2-step trace shows the
# same kernels' split and idle share)
TRACE_STEPS = 2
# The prefill logits, held against the plain SSD's at every position.
# Through all 64 layers of the random-weight model they cannot tell a sound
# SSD from one that rounds its intermediates to bf16: a one-ulp difference
# in a few y entries of one layer grows, layer by layer, about as far as
# that faulty SSD moves them (the distances at 1, 2, 8 and 64 layers are
# printed).  So the logits are held on the model cut to its first layer
# (full width), at both prompt lengths: the largest |err| within two bf16
# ulps of the largest |logit| (LOGITS_TOL), and the distance
# ||logits - plain SSD's|| / ||plain SSD's|| within LOGITS_LINE, a line the
# run itself shows to be sound: the two plain SSDs that differ in rounding
# alone (float64; the time axis summed in reverse) must stay within it and
# both faulty ones (chunk states dropped; bf16 intermediates) must cross
# it.  On an H100 (seed 12) at one layer the sound ones read at most 3.7e-4
# and the kernels 1.9e-4, the faulty ones at least 3.0e-3; at 64 layers the
# bf16 fault read 0.055 beside 0.029-0.045 for the sound ones.  At full
# depth the top token must agree at 1,024 tokens.
LOGITS_DEPTHS = (1, 2, 8)  # the first is held; these and the full depth printed
LOGITS_LINE = 2.0 ** -10
LOGITS_TOL = 2 * BF16_ULP


def rel_dist(torch, a, b) -> float:
    """||a - b|| / ||b|| over every entry, in float64."""
    return float(torch.linalg.vector_norm(a - b, dtype=torch.float64)
                 / torch.linalg.vector_norm(b, dtype=torch.float64))


def profiled(torch, fn, ranges=()):
    """Run ``fn`` under torch.profiler → (wall ms, device kernel ms, device
    copy ms, [(device ms, kernel name)] by time, {range: (host ms, device
    ms of the work launched in it)} for the ``record_function`` ranges
    named in ``ranges``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    avg = prof.key_averages()
    dev = [e for e in avg if e.device_type == DeviceType.CUDA]
    copy = sum(e.self_device_time_total for e in dev if e.key.startswith("Mem")) / 1e3
    kern = sorted(((e.self_device_time_total / 1e3, e.key) for e in dev
                   if not e.key.startswith("Mem") and e.key not in ranges), reverse=True)
    spans = {e.key: (e.cpu_time_total / 1e3, e.device_time_total / 1e3) for e in avg
             if e.key in ranges and e.device_type == DeviceType.CPU}
    check(set(spans) == set(ranges), f"profiled: ranges {sorted(set(ranges) - set(spans))} "
          "not in the trace")
    return wall, sum(t for t, _ in kern), copy, kern, spans


def scan_variants(torch, mod):
    """Plain SSDs for the serving checks, by name → (scan, faulty): two
    faulty ones that the checks must catch (the inbound chunk states
    dropped; C·Bᵀ, M and the chunk states rounded to bf16), and two that
    differ from the plain version in rounding alone (the intra-chunk pass in
    float64; in float32 with the chunk's time axis summed in reverse)."""

    def bf16(t):
        return t.to(torch.bfloat16).float()

    def intra(x, log_a, b, c, chunk, dt=torch.float32, rnd=lambda t: t, reverse=False):
        bt, S, H, Pd = x.shape
        N, L = b.shape[-1], int(chunk)
        nc = S // L
        xf = x.to(dt).reshape(bt, nc, L, H, Pd)
        bf, cf = b.to(dt).reshape(bt, nc, L, N), c.to(dt).reshape(bt, nc, L, N)
        cum = log_a.to(dt).reshape(bt, nc, L, H).cumsum(2)
        causal = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()[..., None]
        diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]
        lmask = torch.where(causal, torch.exp(torch.where(causal, diff, 0.0)), 0.0)
        m = rnd(rnd(torch.einsum("bnik,bnjk->bnij", cf, bf))[..., None] * lmask)
        y = (torch.einsum("bnijh,bnjhp->bnihp", m.flip(3), xf.flip(2)) if reverse
             else torch.einsum("bnijh,bnjhp->bnihp", m, xf))
        bw = bf[:, :, :, None, :] * torch.exp(cum[:, :, -1:, :] - cum)[..., None]
        state = rnd(torch.einsum("bnlhk,bnlhp->bnhkp", bw, xf)).float()
        return mod.ssd_chunk_inter_plain(y.reshape(bt, S, H, Pd).to(x.dtype), state, log_a, c)

    def no_chunk_state(x, log_a, b, c, chunk):
        y, state = mod.ssd_chunk_intra_plain(x, log_a, b, c, chunk)
        return mod.ssd_chunk_inter_plain(y, torch.zeros_like(state), log_a, c)

    return {"bf16 intermediates": (lambda *a: intra(*a, rnd=bf16), True),
            "no chunk state": (no_chunk_state, True),
            "float64 intra-chunk pass": (lambda *a: intra(*a, dt=torch.float64), False),
            "time axis summed in reverse": (lambda *a: intra(*a, reverse=True), False)}


def serving(torch, ops, cfg, dev, record):
    """``cfg`` (mamba2_2p7b) behind an OpportunisticServer on ``dev``;
    returns the launch counts of the requests."""
    import numpy as np

    from repro_torch.models import init_model
    from repro_torch.models.lm import forward, init_cache
    from repro_torch.serve import OpportunisticServer, greedy_generate, make_serve_fns

    t0 = time.perf_counter()
    model = init_model(cfg, seed=SERVE_SEED, device=dev)
    torch.cuda.synchronize()
    params = list(model.parameters())
    print(f"[serve] {cfg.name} at full width: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{sum(p.numel() for p in params)} parameters, "
          f"{sum(p.numel() * p.element_size() for p in params)} bytes on the card, "
          f"made in {time.perf_counter() - t0} s", flush=True)
    srv = OpportunisticServer(cfg, model, capacity=2048, device=dev)
    rng = np.random.default_rng(SERVE_SEED)
    cold_p, warm_p = (tuple(int(t) for t in rng.integers(0, cfg.vocab, 1024)) for _ in range(2))
    odd_p = tuple(int(t) for t in rng.integers(0, cfg.vocab, 1000))

    def request(label, prompt):
        t0 = time.perf_counter()
        out = srv.request(prompt, n_tokens=N_TOKENS)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        rec = srv.metrics.interactions[-1]
        print(f"[serve] {label}: {len(prompt)}-token prompt, {N_TOKENS} tokens: wall {wall} ms, "
              f"sim latency {rec.latency_s * 1e3} ms, ops executed {rec.ops_executed}", flush=True)
        return out, rec

    mod = ops.KERNELS["ssd_chunk_scan"]
    plain_inter, plain_runs = mod.ssd_chunk_inter_plain, []

    def watched_inter(*args):  # the plain step 2's loop over chunks, on the card
        plain_runs.append(args[0].device.type)
        return plain_inter(*args)

    ops.reset_launch_counts()  # counts start at 0 just before the serving path
    mod.ssd_chunk_inter_plain = watched_inter
    try:
        with record():
            cold = request("cold request", cold_p)
            srv.anticipate(warm_p)
            t0 = time.perf_counter()
            srv.think(10.0)
            torch.cuda.synchronize()
            print(f"[serve] think(10): anticipated 1024-token prefill, wall "
                  f"{(time.perf_counter() - t0) * 1e3} ms", flush=True)
            warm = request("warm request", warm_p)
            again = request("resubmission", warm_p)
            odd = request("one-token-chunk request", odd_p)
    finally:
        mod.ssd_chunk_inter_plain = plain_inter
    launches = ops.launch_counts()
    print("[serve] launches: " + json.dumps(launches))
    check(not plain_runs, f"the served prefills ran the plain inter-chunk scan {plain_runs}")
    check(launches["ssd_chunk_scan"] == 3 * cfg.n_layers,
          f"3 prefills launched ssd_chunk_scan {launches['ssd_chunk_scan']} times, "
          f"not {3 * cfg.n_layers}")
    # the two 1,024-token prefills (chunks of 128) on ssd_wgmma and ssd_scan,
    # the 1,000-token one (one-token chunks) on ssd_recur alone, none on
    # ssd_short or ssd_cells
    for name, want in (("wgmma", 2), ("inter", 2), ("recur", 1), ("short", 0), ("cells", 0)):
        got = launches[f"ssd_chunk_scan_{name}"]
        check(got == want * cfg.n_layers, f"3 prefills launched ssd_chunk_scan_{name} {got} "
              f"times, not {want * cfg.n_layers}")
    check(warm[1].latency_s < cold[1].latency_s, "the warm request was not faster (sim)")
    check(again[1].ops_executed == 0 and again[1].latency_s == 0.0,
          "the resubmission was not a cache hit")
    check(np.array_equal(again[0].tokens, warm[0].tokens), "resubmission tokens differ")
    check(odd[0].tokens.shape == (N_TOKENS,), "one-token-chunk request tokens")

    pre, dec, _ = make_serve_fns(cfg, srv.ctx, capacity=2048)
    warm_t = torch.tensor([warm_p], device=dev)
    recomputed = greedy_generate(cfg, model, pre, dec, warm_t, N_TOKENS)[0].cpu().numpy()
    check(np.array_equal(recomputed, warm[0].tokens), "warm tokens != a cold recompute")

    cold_t, odd_t = torch.tensor([cold_p], device=dev), torch.tensor([odd_p], device=dev)
    plain = mod.ssd_chunk_scan_plain
    variants = scan_variants(torch, mod)

    def logits(backend, prompt_t, depth, scan=plain, inputs=None):
        """prefill logits (float32) at every position of the model cut to its
        first ``depth`` layers, on ``backend``, ``scan`` as the plain SSD;
        ``inputs`` collects each layer's SSD arguments"""
        def hooked(*args):
            if inputs is not None:
                inputs.append(args)
            return scan(*args)

        cut = dataclasses.replace(cfg, n_layers=depth)
        mod.ssd_chunk_scan_plain = hooked
        try:
            with torch.no_grad(), ops.local_backend(backend):
                out, _, _ = forward(model, cut, prompt_t, srv.ctx,
                                    cache=init_cache(cut, 1, 2048, dev),
                                    start_pos=torch.zeros((), dtype=torch.int32, device=dev))
        finally:
            mod.ssd_chunk_scan_plain = plain
        return out[0].float()

    def hold_layers(prompt_t, label):
        """every layer's SSD on the model's own inputs (those of the plain
        prefill) within check_ssd's limits, each faulty plain SSD over them
        at every layer"""
        layers = []
        logits("torch", prompt_t, cfg.n_layers, inputs=layers)
        check(len(layers) == cfg.n_layers, f"{label}: {len(layers)} SSD calls")
        worst, moved = [0.0, 0.0], 0.0  # moved: the largest share of y entries that differ
        for i, args in enumerate(layers):
            want = plain(*args)
            got = mod.ssd_chunk_scan(*args)
            worst = [max(w, r) for w, r in zip(worst, ssd_ratios(torch, got, want))]
            moved = max(moved, float((got[0] != want[0]).float().mean()))
            check(max(worst) <= 1.0, f"ssd_chunk_scan at layer {i} of the {label}: "
                  f"|err| / limit (y, h) {worst}")
            for name, (fn, faulty) in variants.items():
                if faulty:
                    over = max(ssd_ratios(torch, fn(*args), want))
                    check(over > 1.0, f"control, plain SSD with {name}: within check_ssd's "
                          f"limits at layer {i} of the {label} ({over} of the limit)")
        print(f"[serve] {label}: all {cfg.n_layers} layers' SSD on the model's own inputs "
              f"within check_ssd's limits (worst |err| / limit: y {worst[0]}, h {worst[1]}; at "
              f"most {moved} of a layer's y entries differ); both faulty controls over them at "
              f"every layer", flush=True)

    def hold_logits(prompt_t, label):
        """the logits of the kernel and of every plain SSD variant against
        the plain SSD's at LOGITS_DEPTHS; held at the first depth, printed at
        the others → (kernel, plain) last-token logits at full depth"""
        for depth in LOGITS_DEPTHS + (cfg.n_layers,):
            lp = logits("torch", prompt_t, depth)
            lk = logits("cuda", prompt_t, depth)
            check(bool(torch.isfinite(lk).all()), f"{label}, {depth} layers: logits not finite")
            ulps = LOGITS_TOL * float(lp.abs().max())
            dist = {"kernel": rel_dist(torch, lk, lp)}
            for name, (fn, faulty) in variants.items():
                dist[name] = rel_dist(torch, logits("torch", prompt_t, depth, fn), lp)
            err = float((lk - lp).abs().max())
            if depth == LOGITS_DEPTHS[0]:
                check(err <= ulps, f"{label}, {depth} layer: logits max |err| {err} over two "
                      f"bf16 ulps of the largest, {ulps}")
                for name, d in dist.items():
                    faulty = name != "kernel" and variants[name][1]
                    check(d > LOGITS_LINE if faulty else d <= LOGITS_LINE,
                          f"{label}, {depth} layer: logits with {name} at {d} of the plain "
                          f"SSD's, {'within' if faulty else 'over'} the line {LOGITS_LINE}")
            print(f"[serve] {label}, {depth} of {cfg.n_layers} layers: logits max |err| {err} "
                  f"(two bf16 ulps: {ulps}); ||logits - plain SSD's|| / ||plain SSD's||, all "
                  f"positions (line {LOGITS_LINE}"
                  f"{', held' if depth == LOGITS_DEPTHS[0] else ', not held'}): "
                  + json.dumps(dist), flush=True)
        return lk[-1], lp[-1]

    for prompt_t, label in ((odd_t, "1,000-token prefill (ssd_recur)"),
                            (cold_t, "1,024-token prefill (ssd_wgmma)")):
        hold_layers(prompt_t, label)
        lk, lp = hold_logits(prompt_t, label)
    check(int(lk.argmax()) == int(lp.argmax()), "1,024-token prefill: the top token differs "
          "from the plain SSD's")

    # the one-token-chunk rule's cost: both prefills alone, synchronized
    walls = {}
    scans = mod.launches_scan.value
    mod.ssd_chunk_inter_plain = watched_inter
    try:
        for label, prompt_t in (("1024", cold_t), ("1000", odd_t)):
            t0 = time.perf_counter()
            pre(model, prompt_t)
            torch.cuda.synchronize()
            walls[label] = (time.perf_counter() - t0) * 1e3
    finally:
        mod.ssd_chunk_inter_plain = plain_inter
    check(not plain_runs and mod.launches_scan.value - scans == cfg.n_layers,
          "the timed 1,024-token prefill did not run the inter-chunk scan kernel once a layer")
    print(f"[serve] prefill wall: 1,024 tokens (chunks of 128) {walls['1024']} ms, 1,000 tokens "
          f"(one-token chunks) {walls['1000']} ms, factor {walls['1000'] / walls['1024']}",
          flush=True)
    # ssd_recur's share of it: the 1,000-token prefill on its route and with
    # scan_route made to answer "pair" (ssd_short, then ssd_scan), in turns
    # (the host's pace drifts between calls far more than 64 launches
    # change it)
    route, odd = mod.scan_route, {"recur": [], "pair": []}
    for kind in ("recur", "pair", "pair", "recur", "recur", "pair"):
        mod.scan_route = route if kind == "recur" else (lambda *args: "pair")
        try:
            t0 = time.perf_counter()
            pre(model, odd_t)
            torch.cuda.synchronize()
        finally:
            mod.scan_route = route
        odd[kind].append((time.perf_counter() - t0) * 1e3)
    print(f"[serve] 1,000-token prefill wall in turns, ms: on ssd_recur {odd['recur']}, with "
          f"ssd_short + ssd_scan forced {odd['pair']}", flush=True)

    # where a request's time goes: a 1,024- and a 1,000-token prefill, then
    # decode steps; the inter-chunk scan's wrapper (the decays' torch ops,
    # then one ssd_scan launch) and ssd_recur's (the same, then one
    # ssd_recur launch) are profiler ranges, read for their host and device
    # time
    inter, recur_fn = mod.ssd_chunk_inter, mod.ssd_chunk_recur

    def traced(name, fn):
        def run(*args):
            with torch.profiler.record_function(name):
                return fn(*args)
        return run

    mod.ssd_chunk_inter = traced("ssd_inter_chunk", inter)
    mod.ssd_chunk_recur = traced("ssd_recur_call", recur_fn)
    try:
        for label, fn, span in (
                ("prefill 1024 tokens", lambda: pre(model, cold_t), "ssd_inter_chunk"),
                ("prefill 1000 tokens", lambda: pre(model, odd_t), "ssd_recur_call"),
                (f"prefill 1024 + {N_TOKENS} decode steps",
                 lambda: greedy_generate(cfg, model, pre, dec, cold_t, N_TOKENS),
                 "ssd_inter_chunk")):
            wall, busy, copy, kern, ranges = profiled(torch, fn, (span,))
            ssd = sum(t for t, k in kern if any(f"ssd_{r}" in k for r in ("cells", "short",
                                                                          "wgmma")))
            scan = sum(t for t, k in kern if "ssd_scan" in k)
            recur = sum(t for t, k in kern if "ssd_recur" in k)
            gemm = sum(t for t, k in kern if any(w in k.lower() for w in ("gemm", "nvjet", "xmma",
                                                                          "cutlass")))
            host, device = ranges[span]
            print(f"[serve-trace] {label}: wall {wall} ms, device kernels {busy} ms "
                  f"(intra-chunk SSD {ssd} ms, ssd_scan {scan} ms, ssd_recur {recur} ms, GEMMs "
                  f"{gemm} ms, other {busy - ssd - scan - recur - gemm} ms), device copies "
                  f"{copy} ms, device idle {100 * (1 - (busy + copy) / wall)}%; {span} range: "
                  f"host {host} ms, its device work {device} ms; top: "
                  + ", ".join(f"{k[:50]} {t}" for t, k in kern[:4]), flush=True)
    finally:
        mod.ssd_chunk_inter, mod.ssd_chunk_recur = inter, recur_fn
    del srv, model
    gc.collect()  # the server and its engine's closures form a cycle
    torch.cuda.empty_cache()
    return launches


# --------------------------------------------------------------------------- #
# phase 4d: serving granite_moe_3b_a800m and recurrentgemma_9b at full width    #
# --------------------------------------------------------------------------- #

HYBRID_SERVED = ("granite_moe_3b_a800m", "recurrentgemma_9b")
# A serving step's attention is the cached branch, the reference's plain
# path in both packages: no attention kernel may launch while serving.
# The card's moe_ffn on layer 0's own inputs against the same layer in
# float64 on the CPU: within test_smoke_model_forward_vs_reference's bf16
# limit, 2^-5 of the largest |y|, at every token whose experts (its top k,
# and those of them kept at capacity) agree; a token whose top k differs
# must be a near tie, its swapped experts' float64 logits within 2^-7 of the
# token's largest |logit| (the card rounds x and the router's product to
# bf16).  Such a token can move the capacity cut of its experts, so other
# tokens may keep other experts: they are counted, not held.
MOE_TOL, MOE_TIE = 2.0 ** -5, 2.0 ** -7
# RecurrentGemma cut to one pattern group (rglru, rglru, local_attn),
# decoded token by token from position 0 (as the reference's
# test_decode_matches_full_forward does; a prefill of more than one token
# into the ring is not causal in either package, ROADMAP C7) past the
# 2,048-slot local-attention ring by DECODE_STEPS: every position's logits
# within 2^-5 of the largest |logit| of one cache-free forward over the
# whole sequence, which runs the head-dim-256 forward kernel.
DECODE_STEPS, DECODE_TOL = 128, 2.0 ** -5


def moe_layer0(torch, cfg, model, prompt_t, dev):
    """The layer-0 moe_ffn of an MoE model on its own inputs (captured during a
    prefill) on the card against float64 on the CPU; the assignments dropped
    at capacity counted on the card, by the CPU's dispatch of the card's
    routing, and by the float64 routing."""
    import dataclasses as dc

    from repro_torch.models import SINGLE, blocks, moe
    from repro_torch.serve import make_serve_fns

    seen = []
    ffn = blocks.moe_ffn

    def capture(params, cfg_, x, ctx):
        if not seen:
            seen.append((params, x.detach().clone()))
        return ffn(params, cfg_, x, ctx)

    pre, _, _ = make_serve_fns(cfg, SINGLE, capacity=2048)
    blocks.moe_ffn = capture
    try:
        pre(model, prompt_t)
    finally:
        blocks.moe_ffn = ffn
    params, x = seen[0]
    T, E = x.shape[0] * x.shape[1], cfg.moe.n_experts
    cap = moe.expert_capacity(cfg, T)
    # one forward reads nothing back to the host (the routing counts its
    # experts at a fixed size, ROADMAP C12): any synchronizing call raises
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.no_grad():
            moe.moe_ffn(params, cfg, x, SINGLE)
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    torch.cuda.synchronize()
    print(f"[serve-moe] {cfg.name}: a layer-0 moe_ffn forward ({T} tokens) ran under "
          "set_sync_debug_mode('error') with no host synchronization", flush=True)
    with torch.no_grad():
        y_card, _ = moe.moe_ffn(params, cfg, x, SINGLE)
        _, e_card, _ = moe._route(params, cfg, x.reshape(T, -1), E)
        p64 = {k: v.detach().double().cpu() for k, v in params.items()}
        x64 = x.double().cpu()
        y64, _ = moe.moe_ffn(p64, dc.replace(cfg, dtype="float32"), x64, SINGLE)
        _, e64, _ = moe._route(p64, cfg, x64.reshape(T, -1), E)
        logit64 = x64.reshape(T, -1) @ p64["router"]
    y_card = y_card.double().cpu().reshape(T, -1)
    y64 = y64.reshape(T, -1)
    order, keep, _ = moe._dispatch(e_card, E, cap)
    c_order, c_keep, _ = moe._dispatch(e_card.cpu(), E, cap)
    o64, k64, _ = moe._dispatch(e64, E, cap)

    def kept_sets(e, order, keep):
        flat = torch.zeros(e.numel(), dtype=torch.bool)
        flat[order.cpu()] = keep.cpu()
        return torch.sort(torch.where(flat.view(e.shape), e.cpu(), -1), -1).values

    differ = (torch.sort(e_card.cpu(), -1).values != torch.sort(e64, -1).values).any(-1)
    moved = (kept_sets(e_card, order, keep) != kept_sets(e64, o64, k64)).any(-1) & ~differ
    err = (y_card - y64).abs().max(-1).values
    scale = float(y64.abs().max())
    agree = ~differ & ~moved
    held = float(err[agree].max()) if bool(agree.any()) else 0.0
    check(int(agree.sum()) >= T // 2, f"{cfg.name} layer 0: only {int(agree.sum())} of {T} tokens "
          "keep the same experts on the card and in float64")
    check(held <= MOE_TOL * scale, f"{cfg.name} layer-0 moe_ffn on the card vs float64: max |err| "
          f"{held} over {MOE_TOL} of the largest |y| {scale} at tokens whose experts agree")
    gaps = []
    for t in torch.nonzero(differ).flatten().tolist():
        a, b = set(e64[t].tolist()), set(e_card[t].cpu().tolist())
        lost, taken = sorted(a - b), sorted(b - a)
        gap = float(logit64[t, lost].max() - logit64[t, taken].min())
        gaps.append(gap / float(logit64[t].abs().max()))
    check(all(g <= MOE_TIE for g in gaps), f"{cfg.name} layer 0: a token's experts differ from "
          f"float64's beyond a near tie (gaps / max |logit| {gaps})")
    d_card = set(order[~keep].cpu().tolist())
    d_cpu = set(c_order[~c_keep].tolist())
    d64 = set(o64[~k64].tolist())
    check(d_card == d_cpu, f"{cfg.name} layer 0: {len(d_card)} assignments dropped on the card, "
          f"{len(d_cpu)} by the CPU's dispatch of the same routing (or other ones)")
    if not bool(differ.any()):
        check(d_card == d64, f"{cfg.name} layer 0: the dropped assignments differ from float64's")
    print(f"[serve-moe] {cfg.name} layer 0, {T} tokens, capacity {cap}: moe_ffn on the card vs "
          f"float64 on the CPU, max |err| {float(err.max())} at all tokens, {held} at the "
          f"{int(agree.sum())} whose experts agree (limit {MOE_TOL * scale}); "
          f"{int(differ.sum())} tokens take other experts, swap gaps / max |logit| {gaps} "
          f"(limit {MOE_TIE}), {int(moved.sum())} others keep other experts at capacity; "
          f"dropped at capacity: {len(d_card)} on the card, {len(d_cpu)} by "
          f"the CPU's dispatch of the card's routing, {len(d64)} by the float64 routing",
          flush=True)


@contextlib.contextmanager
def routes_taken(torch, replay=None):
    """``moe._route`` watched: the yielded list gets, for each call, (the
    experts it took, its router's own top k); with ``replay``, call i takes
    ``replay[i]``'s experts, its weights and aux losses from its own
    router's probabilities."""
    from repro_torch.models import moe

    route, calls = moe._route, []

    def routing(params, cfg_, xf, e_pad):
        if replay is None:
            out = route(params, cfg_, xf, e_pad)
            calls.append((out[1], out[1]))
            return out
        out = route(params, cfg_, xf, e_pad, top_e=replay[len(calls)])
        with torch.no_grad():
            calls.append((out[1], route(params, cfg_, xf, e_pad)[1]))
        return out

    moe._route = routing
    try:
        yield calls
    finally:
        moe._route = route


def moved_tokens(torch, calls):
    """Each ``routes_taken`` call's tokens whose router would take another
    set of experts than the one taken."""
    return [int((torch.sort(a, -1).values != torch.sort(b, -1).values).any(-1).sum())
            for a, b in calls]


MOE_RANGES = {"moe routing": "_route", "moe grouping, experts, combine": "_group_and_compute"}


@contextlib.contextmanager
def moe_ranges(torch, on=True):
    """The MoE layer's routing and its grouping, experts and combine each
    in a profiler range (their forward and remat passes: the backward runs
    outside them) → the range names (none when not ``on``)."""
    from repro_torch.models import moe

    if not on:
        yield ()
        return
    originals = {name: getattr(moe, name) for name in MOE_RANGES.values()}

    def in_range(label, fn):
        def wrapped(*args, **kwargs):
            with torch.profiler.record_function(label):
                return fn(*args, **kwargs)
        return wrapped

    for label, name in MOE_RANGES.items():
        setattr(moe, name, in_range(label, originals[name]))
    try:
        yield tuple(MOE_RANGES)
    finally:
        for name, fn in originals.items():
            setattr(moe, name, fn)


def decode_vs_forward(torch, ops, cut, model, dev, S, tag):
    """``model`` run as ``cut`` (its first ``cut.n_layers`` layers), decoded
    token by token from position 0 over ``S`` tokens against one cache-free
    forward over the same tokens, which launches each attention layer's
    forward kernel once: every position's logits within DECODE_TOL of the
    largest |logit|.  An MoE's forward keeps every assignment (its capacity
    factor raised to n_experts / top_k), as each one-token decode step does,
    and each decode step takes the experts the forward took at its position
    in each layer (a random router's near ties tip under the two paths' bf16
    roundings, and a token on other experts is another function); the
    positions whose router would choose otherwise are counted."""
    import dataclasses as dc

    if cut.moe is not None:
        cut = dc.replace(cut, moe=dc.replace(cut.moe, capacity_factor=cut.moe.n_experts
                                             / cut.moe.top_k))
    err, scale, got, want, n_attn, wall, calls = _decode_and_forward(torch, cut, model, dev, S)
    moved = ""
    if calls:
        n = len(calls) // S
        away = (torch.tensor(moved_tokens(torch, calls)).reshape(S, n) > 0).any(-1)
        there = float(err[away.to(err.device)].max()) if bool(away.any()) else 0.0
        moved = (f"; each step on the forward's experts in its {n} MoE layers: "
                 f"{int(away.sum())} positions whose router would take others in some layer "
                 f"(largest |err| there {there}), capacity factor {cut.moe.capacity_factor}")
    worst = float(err.max())
    check(worst <= DECODE_TOL * scale, f"{cut.name} at {cut.n_layers} layers: decode logits max "
          f"|err| {worst} over {DECODE_TOL} of the largest |logit| {scale}")
    ring = ""
    if cut.rglru is not None:
        P = cut.local_window
        ring = (f"; the ring wraps after {P}: first {P} positions {float(err[:P].max())}, after "
                f"{float(err[P:].max())}")
    print(f"[{tag}] {cut.name} cut to {cut.n_layers} layers ({cut.block_pattern}): {S} decode "
          f"steps from position 0 ({wall} ms, {wall / S} ms a step) against one cache-free "
          f"forward over {S} tokens ({n_attn} forward kernel launches): max |err| {worst} "
          f"(limit {DECODE_TOL * scale}){ring}{moved}; top token equal at "
          f"{float((got.argmax(-1) == want.argmax(-1)).float().mean())} of the positions",
          flush=True)


def _decode_and_forward(torch, cut, model, dev, S):
    """decode_vs_forward's two runs, the decode on the forward's experts →
    (each position's max |err|, the largest |logit|, decode logits, forward
    logits, attention layers, the decode's wall ms, the decode's
    ``routes_taken`` calls)."""
    import numpy as np

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import SINGLE
    from repro_torch.models.lm import forward, init_cache
    from repro_torch.serve import make_serve_fns

    shape = (1, S) if cut.n_codebooks == 1 else (1, cut.n_codebooks, S)
    tokens = torch.as_tensor(np.random.default_rng(SERVE_SEED + 1).integers(0, cut.vocab, shape),
                             device=dev)
    pattern = cut.block_pattern
    n_attn = sum(pattern[i % len(pattern)] in ("attn", "local_attn")
                 for i in range(cut.n_layers))
    before = fa.launches_wgmma.value
    with torch.no_grad(), routes_taken(torch) as forward_calls:
        full, _, _ = forward(model, cut, tokens, SINGLE)
    check(fa.launches_wgmma.value - before == n_attn,
          f"{cut.name} at {cut.n_layers} layers: the cache-free forward launched the forward "
          f"kernel {fa.launches_wgmma.value - before} times, not once in each of its {n_attn} "
          "attention layers")
    _, dec, _ = make_serve_fns(cut, SINGLE, capacity=2048)
    steps = []
    replay = [e[t:t + 1] for t in range(S) for e, _ in forward_calls]
    t0 = time.perf_counter()
    with torch.no_grad(), routes_taken(torch, replay if replay else None) as calls:
        cache = init_cache(cut, 1, 2048, dev)
        for t in range(S):
            last, cache = dec(model, cache, tokens[..., t:t + 1],
                              torch.tensor(t, dtype=torch.int32, device=dev))
            steps.append(last.float())
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    want = full[0].float()
    got = torch.cat(steps, 0)
    check(got.shape == want.shape, f"decode logits {tuple(got.shape)}, the forward's "
          f"{tuple(want.shape)}")
    err = (got - want).abs().reshape(S, -1).max(-1).values
    check(bool(torch.isfinite(got).all()), f"{cut.name}: decode logits not finite")
    check(len(calls) == len(replay), f"{cut.name}: the decode routed {len(calls)} times, the "
          f"forward's experts cover {len(replay)}")
    return err, float(want.abs().max()), got, want, n_attn, wall, calls


def trace_split(kern, moe_model):
    """A profile's device kernel ms → (attention, GEMMs, the MoE layer's
    sort / gather / scatter / index kernels (0 for a dense model))."""
    attn = sum(t for t, k in kern if "attn_" in k)
    gemm = sum(t for t, k in kern if any(w in k.lower() for w in ("gemm", "nvjet", "xmma",
                                                                   "cutlass")))
    moved = sum(t for t, k in kern if moe_model and "attn_" not in k and any(
        w in k.lower() for w in ("sort", "scatter", "gather", "index", "radix", "scan")))
    return attn, gemm, moved


def serve_model(torch, ops, cfg, model, dev, tag, checks, trace_decode=True):
    """``model`` behind an OpportunisticServer: a cold 1,024-token request,
    an anticipated prompt prefilled in think(10) and requested, its
    resubmission, RecurrentGemma also a prompt that fills its ring; a
    multi-codebook config's prompts are (K, 1,024).  Warm tokens equal a
    cold recompute, a fresh server gives the same tokens and last logits bit
    for bit, no attention kernel launches; then ``checks(cold prompt)``, a
    prefill and a prefill with N_TOKENS decode steps timed (decode ms a
    token), and profiled: the prefill, and with ``trace_decode`` prefills
    with TRACE_STEPS decode steps.  Returns the requests' launches."""
    import numpy as np

    from repro_torch.serve import OpportunisticServer, greedy_generate, make_serve_fns

    rng = np.random.default_rng(SERVE_SEED)
    K = cfg.n_codebooks

    def prompt(n):
        if K == 1:
            return tuple(int(t) for t in rng.integers(0, cfg.vocab, n))
        return tuple(tuple(int(t) for t in row) for row in rng.integers(0, cfg.vocab, (K, n)))

    cold_p, warm_p = prompt(1024), prompt(1024)
    # RecurrentGemma: a prompt that fills the 2,048-slot local-attention
    # ring, whose decode steps then wrap it
    long_p = prompt(cfg.local_window) if cfg.rglru is not None else None
    shape = "" if K == 1 else f" x {K} codebooks"

    def request(srv, label, prompt):
        t0 = time.perf_counter()
        out = srv.request(prompt, n_tokens=N_TOKENS)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        rec = srv.metrics.interactions[-1]
        print(f"[{tag}] {cfg.name} {label}: {np.shape(prompt)[-1]}-token prompt{shape}, "
              f"{N_TOKENS} tokens: wall {wall} ms, sim latency {rec.latency_s * 1e3} ms, ops "
              f"executed {rec.ops_executed}", flush=True)
        return out, rec

    def last_logits(srv, prompt):
        return srv.engine.display(srv.anticipate(prompt)).logits

    srv = OpportunisticServer(cfg, model, capacity=2048, device=dev)
    ops.reset_launch_counts()  # counts start at 0 just before the serving path
    cold = request(srv, "cold request", cold_p)
    srv.anticipate(warm_p)
    t0 = time.perf_counter()
    srv.think(10.0)
    torch.cuda.synchronize()
    print(f"[{tag}] {cfg.name} think(10): anticipated 1024-token prefill, wall "
          f"{(time.perf_counter() - t0) * 1e3} ms", flush=True)
    warm = request(srv, "warm request", warm_p)
    again = request(srv, "resubmission", warm_p)
    longer = request(srv, f"{len(long_p)}-token request", long_p) if long_p else None
    launches = ops.launch_counts()
    print(f"[{tag}] {cfg.name} launches: " + json.dumps(launches), flush=True)
    attn = {k: v for k, v in launches.items() if k.startswith("flash_attention")}
    check(not any(attn.values()), f"{cfg.name}: the serving path launched attention kernels "
          f"{attn}; the cached branch is the plain path")
    check(warm[1].latency_s < cold[1].latency_s, f"{cfg.name}: the warm request was not faster "
          "(sim)")
    check(again[1].ops_executed == 0 and again[1].latency_s == 0.0,
          f"{cfg.name}: the resubmission was not a cache hit")
    check(np.array_equal(again[0].tokens, warm[0].tokens), f"{cfg.name}: resubmission tokens")

    pre, dec, _ = make_serve_fns(cfg, srv.ctx, capacity=2048)
    warm_t = torch.tensor([warm_p], device=dev)
    recomputed = greedy_generate(cfg, model, pre, dec, warm_t, N_TOKENS)[0].cpu().numpy()
    check(np.array_equal(recomputed, warm[0].tokens), f"{cfg.name}: warm tokens != a cold "
          "recompute")
    # the same requests in a fresh server: tokens and last logits bit for bit
    fresh = OpportunisticServer(cfg, model, capacity=2048, device=dev)
    served = [("cold", cold_p, cold), ("warm", warm_p, warm)] + (
        [("long", long_p, longer)] if long_p else [])
    for label, p, (out, _) in served:
        out2 = fresh.request(p, n_tokens=N_TOKENS)
        check(np.array_equal(out2.tokens, out.tokens), f"{cfg.name} {label}: a fresh server "
              "gave other tokens")
        check(torch.equal(last_logits(fresh, p), last_logits(srv, p)),
              f"{cfg.name} {label}: a fresh server gave other last logits")
    print(f"[{tag}] {cfg.name}: warm tokens equal a cold recompute; a fresh server gave "
          f"the same tokens and last logits bit for bit for {len(served)} requests", flush=True)
    del fresh

    cold_t = torch.tensor([cold_p], device=dev)
    t0 = time.perf_counter()
    checks(cold_t)
    checks_s = time.perf_counter() - t0

    # where a request's time goes: a prefill alone and with N_TOKENS decode
    # steps, timed; then profiled, the decodes at TRACE_STEPS steps
    walls = []
    for n in (0, N_TOKENS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if n:
            greedy_generate(cfg, model, pre, dec, cold_t, n)
        else:
            pre(model, cold_t)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    runs = [("prefill 1024 tokens", lambda: pre(model, cold_t))]
    if trace_decode:
        runs.append((f"prefill 1024 + {TRACE_STEPS} decode steps",
                     lambda: greedy_generate(cfg, model, pre, dec, cold_t, TRACE_STEPS)))
        if long_p:
            long_t = torch.tensor([long_p], device=dev)
            runs.append((f"prefill {len(long_p)} + {TRACE_STEPS} decode steps (the ring wraps)",
                         lambda: greedy_generate(cfg, model, pre, dec, long_t, TRACE_STEPS)))
    t_prof = time.perf_counter()
    for label, fn in runs:
        wall, busy, copy, kern, _ = profiled(torch, fn)
        attn_k, gemm, moved = trace_split(kern, cfg.moe is not None)
        moe_part = (f", MoE sort / gather / scatter / index {moved} ms" if cfg.moe is not None
                    else "")
        print(f"[{tag.split('-')[0]}-trace] {cfg.name} {label}: wall {wall} ms, device kernels "
              f"{busy} ms (GEMMs {gemm} ms, attention kernels {attn_k} ms{moe_part}, other "
              f"{busy - gemm - attn_k - moved} ms), device copies {copy} ms, device idle "
              f"{100 * (1 - (busy + copy) / wall)}%; top: "
              + ", ".join(f"{k[:50]} {t}" for t, k in kern[:5]), flush=True)
    print(f"[{tag.split('-')[0]}-trace] {cfg.name} decode: {(walls[1] - walls[0]) / N_TOKENS} ms "
          f"a token (walls: prefill {walls[0]} ms, with {N_TOKENS} decode steps {walls[1]} ms); "
          f"the model's own checks took {checks_s} s, the profiles {time.perf_counter() - t_prof} "
          "s", flush=True)
    del srv
    gc.collect()  # the server and its engine's closures form a cycle
    return launches


def serving_hybrid(torch, ops, name, dev):
    """``name`` (granite-MoE or RecurrentGemma) at full width and depth
    behind an OpportunisticServer; returns the launch counts of its
    requests (every attention counter must read 0)."""
    import dataclasses as dc

    from repro_torch.configs import get_config
    from repro_torch.models import init_model

    cfg = get_config(name)
    t0 = time.perf_counter()
    model = init_model(cfg, seed=SERVE_SEED, device=dev)
    torch.cuda.synchronize()
    params = list(model.parameters())
    print(f"[serve-hybrid] {cfg.name} at full width: {cfg.n_layers} layers "
          f"({cfg.block_pattern}), d_model {cfg.d_model}, {cfg.n_q_heads}/{cfg.n_kv_heads} heads x "
          f"{cfg.head_dim}, {sum(p.numel() for p in params)} parameters, "
          f"{sum(p.numel() * p.element_size() for p in params)} bytes on the card, made in "
          f"{time.perf_counter() - t0} s", flush=True)
    del params

    def checks(cold_t):
        if cfg.moe is not None:
            moe_layer0(torch, cfg, model, cold_t, dev)
        else:  # one pattern group, decoded past its ring
            decode_vs_forward(torch, ops, dc.replace(cfg, n_layers=len(cfg.block_pattern)),
                              model, dev, cfg.local_window + DECODE_STEPS, "serve-rg")

    launches = serve_model(torch, ops, cfg, model, dev, "serve-hybrid", checks)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# --------------------------------------------------------------------------- #
# phase 4c: training smollm_360m at full width                                 #
# --------------------------------------------------------------------------- #

TRAIN_SEED = 12
TRAIN_STEPS = 4
STEP_MS = {}  # step ms of 4c's run and of 4h (b)'s untraced steps, which phase 4i reads
TRAIN_BATCH, TRAIN_MICRO = 8, 4  # the train_4k shape's global batch 256, cut to one card
CKPT_ROOT = ROOT / ".smoke_ckpt"  # checkpoints of this phase, removed at its end
# predicted launches per step: 32 layers x 2 microbatches x 2 forwards (remat)
# of the forward, and 32 x 2 of each backward kernel, every one of them bf16
# on the tensor-core kernels
PER_STEP = {"flash_attention": 128, "flash_attention_wgmma": 128,
            "flash_attention_bwd_dq": 64, "flash_attention_bwd_dkdv": 64,
            "flash_attention_bwd_dq_wgmma": 64, "flash_attention_bwd_dkdv_wgmma": 64}
# The step with the kernels against the same step with the plain attention
# (one microbatch of 2 x 1,024 tokens, remat off, the seed-12 weights): the
# attention outputs differ by up to a bf16 ulp and each layer moves the next
# one's input.  Sound readings on an H100 (seed 12): loss 3.8e-5 and
# gradient norm 3.9e-5 relative, worst leaf gradient 0.0203 of its largest
# |g|; the limits are 2e-4, 5e-4 and 2^-4.  A plain attention whose backward
# drops one head of each group's dK / dV read 0.93 and must fail the leaf
# limit.
STEP_LOSS_TOL, STEP_GNORM_TOL, STEP_GRAD_TOL = 2e-4, 5e-4, 2.0 ** -4


def leaf_errs(torch, got, want):
    """{leaf: (max |err|, max |want|)} over two gradient trees."""
    from repro_torch.models.base import keystr, tree_flatten

    return {keystr(p): (float((g - w).abs().max()), float(w.abs().max()))
            for (p, g), (_, w) in zip(tree_flatten(got), tree_flatten(want))}


def check_batch(torch, cfg, dev):
    """Check 2's microbatch: 2 x 1,024 tokens (of each codebook), and a VLM's
    ``vis_embeds`` drawn from a seed."""
    from repro_torch.data import SynthSpec, batch_at
    from repro_torch.data.loader import to_device

    batch = to_device(batch_at(SynthSpec(vocab=cfg.vocab, seq_len=1024, batch=2,
                                         n_codebooks=cfg.n_codebooks, seed=0), 0), dev)
    if cfg.n_vis_tokens:
        batch["vis_embeds"] = vis_embeds(torch, cfg, 2, dev)
    return batch


def vis_embeds(torch, cfg, batch, dev, seed=TRAIN_SEED):
    """A VLM's stub patch embeddings (batch, n_vis, d) in bf16, N(0, 1) from
    a numpy seed (the dry run's input spec has them in bf16)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.standard_normal((batch, cfg.n_vis_tokens, cfg.d_model),
                                               dtype=np.float32), device=dev).to(torch.bfloat16)


def step_vs_plain(torch, ops, cfg, model, dev):
    """Check 2: one microbatch's loss, gradient norm and gradients with the
    kernels against the plain attention, and the faulty control."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import SINGLE
    from repro_torch.train.optimizer import global_norm
    from repro_torch.train.trainstep import value_and_grad

    batch = check_batch(torch, cfg, dev)

    def run(backend):
        with ops.local_backend(backend):
            loss, _, grads = value_and_grad(model, cfg, batch, SINGLE, remat=False)
        return float(loss), float(global_norm(grads)), grads

    kl, kn, kg = run("cuda")
    pl, pn, pg = run("torch")
    errs = leaf_errs(torch, kg, pg)
    worst = max(e / max(w, 1e-30) for e, w in errs.values())
    print(f"[train] check 2, 2 x 1,024 tokens, kernels vs plain attention: loss {kl} vs {pl}, "
          f"grad norm {kn} vs {pn}, worst leaf |err| / max |g| {worst}: "
          + json.dumps({k: e / max(w, 1e-30) for k, (e, w) in errs.items()}), flush=True)
    check(math.isfinite(kl) and abs(kl - pl) <= STEP_LOSS_TOL * abs(pl),
          f"training step loss {kl} vs plain {pl}")
    check(math.isfinite(kn) and abs(kn - pn) <= STEP_GNORM_TOL * pn,
          f"training step grad norm {kn} vs plain {pn}")
    check(worst <= STEP_GRAD_TOL, f"training step gradients vs plain: worst {worst}")
    del kg
    controls = attn_controls(torch, fa)
    faulty, _ = controls["dK/dV that skips one head of each group"]
    plain = fa.flash_attention_plain
    fa.flash_attention_plain = faulty
    try:
        _, _, cg = run("torch")
    finally:
        fa.flash_attention_plain = plain
    cworst = max(e / max(w, 1e-30) for e, w in leaf_errs(torch, cg, pg).values())
    check(cworst > STEP_GRAD_TOL, f"control, dK/dV without a head: worst leaf {cworst} is "
          f"within the limit {STEP_GRAD_TOL}, which cannot see it")
    print(f"[train] control, plain attention whose dK/dV drops a head: worst leaf |err| / "
          f"max |g| {cworst}, above the limit {STEP_GRAD_TOL}", flush=True)


def tree_bytes_equal(torch, a, b) -> bool:
    from repro_torch.models.base import tree_flatten

    return all(torch.equal(x, y) for (_, x), (_, y) in zip(tree_flatten(a), tree_flatten(b)))


def training(torch, ops, dev):
    """``smollm_360m`` at full width trained by ``train_loop`` on the card;
    returns the attention kernels' launch counts over the 4-step run."""
    import shutil

    import numpy as np

    from repro_torch.ckpt import CheckpointManager
    from repro_torch.configs import RunConfig, get_config, get_shape
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import SynthSpec, batch_at
    from repro_torch.data.loader import to_device
    from repro_torch.train import train_loop
    from repro_torch.train.trainstep import init_train_state, make_train_step

    cfg = get_config("smollm_360m")
    base = get_shape("train_4k")
    shape = ShapeConfig(base.name, base.kind, base.seq_len, TRAIN_BATCH)
    run = RunConfig(model=cfg, shape=shape, dp=1, tp=1, remat="full", microbatch=TRAIN_MICRO)
    data = SynthSpec(vocab=cfg.vocab, seq_len=shape.seq_len, batch=TRAIN_BATCH, seed=0)
    tokens = shape.seq_len * TRAIN_BATCH
    shutil.rmtree(CKPT_ROOT, ignore_errors=True)
    CKPT_ROOT.mkdir()
    free = shutil.disk_usage(CKPT_ROOT).free
    print(f"[train] {cfg.name} at full width: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_q_heads}/{cfg.n_kv_heads} heads x {cfg.head_dim}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab}; {TRAIN_STEPS} steps of {TRAIN_BATCH} x {shape.seq_len} tokens "
          f"(microbatch {TRAIN_MICRO}, remat full), seed {TRAIN_SEED}; {free} bytes free for "
          "checkpoints", flush=True)
    logs = []
    try:
        # the main path: 4 steps, a checkpoint every 2
        ops.reset_launch_counts()  # counts start at 0 just before the training path
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        whole = train_loop(cfg, run, data, TRAIN_STEPS, ckpt_dir=str(CKPT_ROOT / "whole"),
                           ckpt_every=2, seed=TRAIN_SEED, log_every=1, log_fn=logs.append,
                           device=dev)
        wall = time.perf_counter() - t0
        launches = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        STEP_MS["4c"] = [t * 1e3 for t in whole.step_times]
        print(f"[train] {TRAIN_STEPS} steps in {wall} s (checkpoints included): step ms "
              + json.dumps([t * 1e3 for t in whole.step_times]) + ", tokens/s "
              + json.dumps([tokens / t for t in whole.step_times]) + ", losses "
              + json.dumps(whole.losses) + ", grad norms " + json.dumps(whole.grad_norms)
              + f", peak device memory {peak} bytes", flush=True)
        check(whole.steps == TRAIN_STEPS and all(math.isfinite(x) for x in
                                                 whole.losses + whole.grad_norms),
              "training: a loss or gradient norm is not finite")
        print("[train] launches in the run: " + json.dumps(
            {k: launches[k] for k in PER_STEP}) + "; per step "
            + json.dumps({k: launches[k] / TRAIN_STEPS for k in PER_STEP}), flush=True)
        for name, n in PER_STEP.items():
            check(launches[name] == n * TRAIN_STEPS,
                  f"{name} launched {launches[name]} times in {TRAIN_STEPS} steps, not "
                  f"{n * TRAIN_STEPS}")

        # check 3: the same step twice from the same state, bit for bit; the
        # second run is profiled
        step_fn, _ = make_train_step(cfg, run)
        batch = to_device(batch_at(data, 0), dev)
        states = []
        for i in range(2):
            model, opt_state = init_train_state(cfg, run, seed=TRAIN_SEED, device=dev)
            if i == 0:
                model, opt_state, _ = step_fn(model, opt_state, batch)
            else:
                out = {}

                def one_step():
                    out["state"] = step_fn(model, opt_state, batch)

                pwall, busy, copy, kern, _ = profiled(torch, one_step)
                model, opt_state, _ = out["state"]
            states.append(({"params": model.tree(), "opt": opt_state}))
            del model, opt_state
        check(tree_bytes_equal(torch, states[0], states[1]),
              "the same step from the same state gave other params or optimizer state")
        del states
        torch.cuda.empty_cache()
        attn = sum(t for t, k in kern if "attn_" in k)
        gemm = sum(t for t, k in kern if any(w in k.lower() for w in ("gemm", "nvjet", "xmma",
                                                                       "cutlass")))
        print("[train] check 3: a step repeated from the same state gave params and optimizer "
              "state equal bit for bit", flush=True)
        print(f"[train-trace] one step, profiled: wall {pwall} ms, device kernels {busy} ms "
              f"(attention kernels {attn} ms, GEMMs {gemm} ms, other {busy - attn - gemm} ms), "
              f"device copies {copy} ms, device idle {100 * (1 - (busy + copy) / pwall)}%; top: "
              + ", ".join(f"{k[:50]} {t}" for t, k in kern[:6]), flush=True)

        # check 2: kernels against the plain attention on one microbatch
        model, _ = init_train_state(cfg, run, seed=TRAIN_SEED, device=dev)
        step_vs_plain(torch, ops, cfg, model, dev)
        del model
        torch.cuda.empty_cache()

        # check 4: a run killed at step 3 resumes and ends where the
        # uninterrupted run ended
        cut = str(CKPT_ROOT / "cut")
        try:
            train_loop(cfg, run, data, TRAIN_STEPS, ckpt_dir=cut, ckpt_every=2,
                       seed=TRAIN_SEED, fail_at_step=3, log_fn=logs.append, device=dev)
            fail("fail_at_step=3 did not stop the run")
        except RuntimeError as exc:
            if str(exc) != "injected node failure at step 3":
                raise
        latest = CheckpointManager(cut).latest_step()
        resumed = train_loop(cfg, run, data, TRAIN_STEPS, ckpt_dir=cut, ckpt_every=2,
                             seed=TRAIN_SEED, log_fn=logs.append, device=dev)
        check(resumed.resumed_from == latest and resumed.steps == TRAIN_STEPS - latest,
              f"the run resumed from {resumed.resumed_from}, not from its newest "
              f"checkpoint {latest}")
        a, b = (CKPT_ROOT / n / f"step_{TRAIN_STEPS:08d}" for n in ("whole", "cut"))
        manifest = json.loads((a / "manifest.json").read_text())
        check(manifest == json.loads((b / "manifest.json").read_text()), "manifests differ")
        for entry in manifest["leaves"]:
            check(np.load(a / entry["file"]).tobytes() == np.load(b / entry["file"]).tobytes(),
                  f"resumed run differs from the uninterrupted one at {entry['key']}")
        print(f"[train] check 4: the injected failure at step 3 raised; the rerun resumed from "
              f"step {latest} and its step-{TRAIN_STEPS} checkpoint ({len(manifest['leaves'])} "
              "leaves: params and optimizer state) equals the uninterrupted run's bit for bit; "
              f"losses {resumed.losses} against {whole.losses[latest:]}", flush=True)
    finally:
        shutil.rmtree(CKPT_ROOT, ignore_errors=True)
        torch.cuda.empty_cache()
    print("[train] loop log: " + " | ".join(logs), flush=True)
    return {k: launches[k] for k in PER_STEP}


# --------------------------------------------------------------------------- #
# phase 4e: training recurrentgemma_9b at full width, one pattern group        #
# --------------------------------------------------------------------------- #

# The whole model (9.57e9 parameters) needs 153 GB of float32 weights,
# gradients and AdamW moments; one pattern group (rglru, rglru, local_attn)
# with the 256,000-token embedding and head has 2.69e9, 43 GB.  One
# sequence of 4,096 tokens a step (the train_4k shape's global batch 256,
# cut to one card and this state), remat full.
RG_STEPS, RG_BATCH = 4, 1
# predicted launches per step: 1 local_attn layer x 1 microbatch x 2
# forwards (remat) of the forward, 1 of each backward kernel, every one on
# the tensor-core kernels (bf16, D 256)
RG_PER_STEP = {"flash_attention": 2, "flash_attention_wgmma": 2,
               "flash_attention_bwd_dq": 1, "flash_attention_bwd_dkdv": 1,
               "flash_attention_bwd_dq_wgmma": 1, "flash_attention_bwd_dkdv_wgmma": 1}


def training_rg(torch, ops, dev):
    """``recurrentgemma_9b`` cut to one pattern group, trained by
    ``train_loop`` on the card; returns the attention kernels' launch
    counts over the run."""
    import dataclasses as dc

    from repro_torch.configs import RunConfig, get_config, get_shape
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import SynthSpec, batch_at
    from repro_torch.data.loader import to_device
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import init_model
    from repro_torch.models.base import tree_flatten
    from repro_torch.train import train_loop
    from repro_torch.train.trainstep import init_train_state, make_train_step

    full = get_config("recurrentgemma_9b")
    cfg = dc.replace(full, n_layers=len(full.block_pattern))
    base = get_shape("train_4k")
    shape = ShapeConfig(base.name, base.kind, base.seq_len, RG_BATCH)
    run = RunConfig(model=cfg, shape=shape, dp=1, tp=1, remat="full", microbatch=RG_BATCH)
    data = SynthSpec(vocab=cfg.vocab, seq_len=shape.seq_len, batch=RG_BATCH, seed=0)
    check(fa.forward_route(torch.bfloat16, cfg.head_dim) == "wgmma"
          and fa.backward_route(torch.bfloat16, cfg.head_dim) == "wgmma",
          "RecurrentGemma's head dim is not on the tensor-core route")
    print(f"[train-rg] {cfg.name} cut to {cfg.n_layers} layers ({cfg.block_pattern}) at full "
          f"width: d_model {cfg.d_model}, {cfg.n_q_heads}/{cfg.n_kv_heads} heads x "
          f"{cfg.head_dim}, lru width {cfg.rglru.lru_width}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, "
          f"{cfg.param_count()} parameters; {RG_STEPS} steps of {RG_BATCH} x {shape.seq_len} "
          f"tokens (microbatch {RG_BATCH}, remat full), seed {TRAIN_SEED}", flush=True)
    logs = []
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[train-rg] {torch.cuda.memory_allocated()} bytes held on the card before the run",
          flush=True)
    ops.reset_launch_counts()  # counts start at 0 just before the training path
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    whole = train_loop(cfg, run, data, RG_STEPS, seed=TRAIN_SEED, log_every=1,
                       log_fn=logs.append, device=dev)
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    tokens = shape.seq_len * RG_BATCH
    print(f"[train-rg] {RG_STEPS} steps in {wall} s: step ms "
          + json.dumps([t * 1e3 for t in whole.step_times]) + ", tokens/s "
          + json.dumps([tokens / t for t in whole.step_times]) + ", losses "
          + json.dumps(whole.losses) + ", grad norms " + json.dumps(whole.grad_norms)
          + f", peak device memory {peak} bytes", flush=True)
    check(whole.steps == RG_STEPS and all(math.isfinite(x) for x in
                                          whole.losses + whole.grad_norms),
          "RecurrentGemma training: a loss or gradient norm is not finite")
    print("[train-rg] launches in the run: " + json.dumps(
        {k: launches[k] for k in RG_PER_STEP}), flush=True)
    for name, n in RG_PER_STEP.items():
        check(launches[name] == n * RG_STEPS, f"RecurrentGemma training: {name} launched "
              f"{launches[name]} times in {RG_STEPS} steps, not {n * RG_STEPS}")
    torch.cuda.empty_cache()

    # the same step twice from the same state, bit for bit: the first
    # state waits on the host (two do not fit on the card beside a step)
    gc.collect()
    step_fn, _ = make_train_step(cfg, run)
    batch = to_device(batch_at(data, 0), dev)
    kept = None
    for i in range(2):
        model, opt_state = init_train_state(cfg, run, seed=TRAIN_SEED, device=dev)
        if i == 0:
            model, opt_state, m0 = step_fn(model, opt_state, batch)
            kept = [t.detach().cpu() for _, t in tree_flatten({"params": model.tree(),
                                                               "opt": opt_state})]
        else:
            out = {}

            def one_step():
                out["state"] = step_fn(model, opt_state, batch)

            pwall, busy, copy, kern, _ = profiled(torch, one_step)
            model, opt_state, m1 = out["state"]
            leaves = [t for _, t in tree_flatten({"params": model.tree(), "opt": opt_state})]
            check(len(leaves) == len(kept) and all(
                torch.equal(a.detach().cpu(), b) for a, b in zip(leaves, kept)),
                "RecurrentGemma: the same step from the same state gave other params or "
                "optimizer state")
            check(float(m0["loss"]) == float(m1["loss"]), "RecurrentGemma: repeated step loss")
        del model, opt_state
    del kept
    torch.cuda.empty_cache()
    attn = sum(t for t, k in kern if "attn_" in k)
    gemm = sum(t for t, k in kern if any(w in k.lower() for w in ("gemm", "nvjet", "xmma",
                                                                   "cutlass")))
    print("[train-rg] a step repeated from the same state gave params and optimizer state "
          "equal bit for bit", flush=True)
    print(f"[train-rg-trace] one step, profiled: wall {pwall} ms, device kernels {busy} ms "
          f"(attention kernels {attn} ms, GEMMs {gemm} ms, other {busy - attn - gemm} ms), "
          f"device copies {copy} ms, device idle {100 * (1 - (busy + copy) / pwall)}%; top: "
          + ", ".join(f"{k[:50]} {t}" for t, k in kern[:8]), flush=True)

    # kernels against the plain attention on one microbatch
    model = init_model(cfg, seed=TRAIN_SEED, device=dev, trainable=True)
    step_vs_plain(torch, ops, cfg, model, dev)
    del model
    torch.cuda.empty_cache()
    print("[train-rg] loop log: " + " | ".join(logs), flush=True)
    return {k: launches[k] for k in RG_PER_STEP}


# --------------------------------------------------------------------------- #
# phase 4f: granite-MoE trained at full width through the training loop      #
# --------------------------------------------------------------------------- #

# granite_moe_3b_a800m at full width (d_model 1536, 24 / 8 heads x 64, 40
# experts top 8, d_ff_expert 512, vocab 49,155) cut to 16 of its 32 layers
# (1.76e9 parameters), so that the script keeps to its time: at 32 layers
# (54 GB of float32 weights, gradients and AdamW moments) the 40.5 GB
# checkpoint's write and read take most of the phase.  The cut config goes
# through ``train_loop`` as the train launcher drives it (``train_cut``), as
# phase 4k trains its cut models.  Phase 4c's shape (4 steps of 8 x 4,096
# tokens, microbatch 4, remat full): 16 layers x 2 microbatches x 2 forward
# launches a step, 32 of each backward kernel.
MOE_SEQ = 4096
# cut to 8 of 32 layers so that the whole script, phase 4m included, keeps to its time
MOE_LAYERS = 8
# each of 2 microbatches runs each layer's forward twice (remat) and its backward once
MOE_PER_STEP = {"flash_attention": 4 * MOE_LAYERS, "flash_attention_wgmma": 4 * MOE_LAYERS,
                "flash_attention_bwd_dq": 2 * MOE_LAYERS, "flash_attention_bwd_dkdv": 2 * MOE_LAYERS,
                "flash_attention_bwd_dq_wgmma": 2 * MOE_LAYERS,
                "flash_attention_bwd_dkdv_wgmma": 2 * MOE_LAYERS}
MOE_CUT = 2  # the interrupted run fails at step 2 and resumes from its step-2 checkpoint
# The peak, predicted before the first run at 8 layers: weights, both
# moments and the accumulated gradients (4 x 3.8 GB), a second gradient
# tree while the second microbatch's backward fills it, the loss head's
# float32 logits of 4 x 4,096 tokens and their gradient (16 layers peaked at
# 45,587,954,688 bytes, 17.4 GB over their state).
MOE_PEAK_PREDICTED = (26e9, 34e9)
MASK64 = (1 << 64) - 1


def launcher_opt(steps):
    """The train launcher's AdamW at its default ``--lr`` over ``steps``
    steps (``repro_torch.launch.train.main``), for a config cut in depth,
    which the launcher does not take."""
    from repro_torch.train.optimizer import AdamWConfig

    return AdamWConfig(lr=3e-3, warmup_steps=min(20, steps // 5), total_steps=steps)


def train_cut(cfg, run, dev, ckpt_dir, fail_at_step=None):
    """``train_loop`` on ``cfg`` (cut in depth) for TRAIN_STEPS steps of
    ``run``'s shape from the synthetic stream, with the launcher's
    optimizer, seed, log rate and checkpoint period → (stats, log lines)."""
    from repro_torch.data import SynthSpec
    from repro_torch.train import loop

    data = SynthSpec(vocab=cfg.vocab, seq_len=run.shape.seq_len, batch=run.shape.global_batch,
                     n_codebooks=cfg.n_codebooks, seed=TRAIN_SEED)
    log = []
    stats = loop.train_loop(cfg, run, data, total_steps=TRAIN_STEPS, ckpt_dir=ckpt_dir,
                            ckpt_every=50, opt=launcher_opt(TRAIN_STEPS), seed=TRAIN_SEED,
                            fail_at_step=fail_at_step, log_every=max(1, TRAIN_STEPS // 10),
                            log_fn=log.append, device=dev)
    return stats, log


def fingerprint(torch, tree):
    """{leaf: (the sum of its 32-bit words, the sum of each word times its
    index mod 65,521 plus 1), both mod 2^64}, computed on the card."""
    from repro_torch.models.base import keystr, tree_flatten

    out = {}
    for path, t in tree_flatten(tree):
        words = t.detach().reshape(-1).view(torch.uint8).view(torch.int32)
        s1 = s2 = 0
        for a in range(0, words.numel(), 1 << 26):
            w = words[a:a + (1 << 26)].long()
            pos = torch.arange(a, a + w.numel(), device=w.device) % 65521 + 1
            s1 += int(w.sum())
            s2 += int((w * pos).sum())
        out[keystr(path)] = (s1 & MASK64, s2 & MASK64)
    return out


def moe_step_vs_plain(torch, ops, cfg, model, dev):
    """Check 2 for an MoE model: one microbatch (2 x 1,024 tokens, remat
    off) with the kernels against the plain attention, the plain run taking
    the kernel run's experts (each token's top k, in each layer; its
    weights and aux losses from its own router): a random router's near
    ties tip under the attentions' one-ulp differences, and a token that
    moves moves every leaf's gradient, so the experts are replayed and every
    leaf is held to phase 4c's limits.  The tokens whose router in the plain
    run would take other experts are counted.  The control whose dK/dV
    drops a head, with the same experts, must cross the leaf limit."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import SINGLE
    from repro_torch.train.optimizer import global_norm
    from repro_torch.train.trainstep import value_and_grad

    batch = check_batch(torch, cfg, dev)

    def routed(backend, fn, replay=None):
        """``fn()`` under ``backend`` → (its result, its ``routes_taken``
        calls)."""
        with routes_taken(torch, replay) as calls, ops.local_backend(backend):
            return fn(), calls

    def step():
        loss, _, grads = value_and_grad(model, cfg, batch, SINGLE, remat=False)
        return float(loss), float(global_norm(grads)), grads

    (kl, kn, kg), calls = routed("cuda", step)
    experts = [e for e, _ in calls]
    (pl, pn, pg), plain_calls = routed("torch", step, experts)
    moved = moved_tokens(torch, plain_calls)
    errs = leaf_errs(torch, kg, pg)
    del kg
    ratios = {k: e / max(w, 1e-30) for k, (e, w) in errs.items()}
    worst = max(ratios.values())
    print(f"[train-moe] check 2, 2 x 1,024 tokens, kernels vs plain attention, the plain run on "
          f"the kernel run's experts: loss {kl} vs {pl}, grad norm {kn} vs {pn}, worst leaf "
          f"|err| / max |g| {worst}; tokens whose router in the plain run would take another "
          f"top-k set, per layer {json.dumps(moved)} ({sum(moved)} of {len(moved) * 2048}): "
          + json.dumps(ratios), flush=True)
    check(math.isfinite(kl) and abs(kl - pl) <= STEP_LOSS_TOL * abs(pl),
          f"MoE training step loss {kl} vs plain {pl}")
    check(math.isfinite(kn) and abs(kn - pn) <= STEP_GNORM_TOL * pn,
          f"MoE training step grad norm {kn} vs plain {pn}")
    check(worst <= STEP_GRAD_TOL, f"MoE training step gradients vs plain: worst {worst}")
    controls = attn_controls(torch, fa)
    faulty, _ = controls["dK/dV that skips one head of each group"]
    plain = fa.flash_attention_plain
    fa.flash_attention_plain = faulty
    try:
        (_, _, cg), _ = routed("torch", step, experts)
    finally:
        fa.flash_attention_plain = plain
    cworst = max(e / max(w, 1e-30) for e, w in leaf_errs(torch, cg, pg).values())
    check(cworst > STEP_GRAD_TOL, f"MoE control, dK/dV without a head: worst leaf {cworst} is "
          f"within the limit {STEP_GRAD_TOL}, which cannot see it")
    print(f"[train-moe] control, plain attention whose dK/dV drops a head, on the same experts: "
          f"worst leaf |err| / max |g| {cworst}, above the limit {STEP_GRAD_TOL}", flush=True)


def training_moe(torch, ops, dev):
    """``granite_moe_3b_a800m`` at full width, cut to MOE_LAYERS layers,
    trained through ``train_loop`` (``train_cut``); returns the attention
    kernels' launch counts over the main run."""
    import shutil

    from repro_torch.ckpt import CheckpointManager
    from repro_torch.configs import RunConfig, get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import SynthSpec, batch_at
    from repro_torch.data.loader import to_device
    from repro_torch.models import init_model, moe
    from repro_torch.models.base import tree_flatten
    from repro_torch.train import loop
    from repro_torch.train.trainstep import init_train_state, make_train_step

    cfg = dataclasses.replace(get_config("granite_moe_3b_a800m"), n_layers=MOE_LAYERS)
    shape = ShapeConfig("cli", "train", seq_len=MOE_SEQ, global_batch=TRAIN_BATCH)
    run = RunConfig(model=cfg, shape=shape, dp=1, tp=1, remat="full", microbatch=TRAIN_MICRO)
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(CKPT_ROOT, ignore_errors=True)
    CKPT_ROOT.mkdir()
    free = shutil.disk_usage(CKPT_ROOT).free
    state_bytes = 12 * cfg.param_count()  # weights and both moments, float32
    check(free > state_bytes * 1.1, f"{free} bytes free for a {state_bytes}-byte checkpoint")
    cap = moe.expert_capacity(cfg, TRAIN_MICRO * MOE_SEQ)
    print(f"[train-moe] {cfg.name} at full width cut to {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_q_heads}/{cfg.n_kv_heads} heads x {cfg.head_dim}, "
          f"{cfg.moe.n_experts} experts top {cfg.moe.top_k}, d_ff_expert "
          f"{cfg.moe.d_ff_expert}, vocab {cfg.vocab}, {cfg.param_count()} parameters; "
          f"train_loop on the cut config, {TRAIN_STEPS} steps of {TRAIN_BATCH} x {MOE_SEQ} "
          f"tokens, microbatch {TRAIN_MICRO}, remat full, seed {TRAIN_SEED}, the launcher's "
          f"AdamW; capacity {cap} a microbatch; predicted peak "
          f"{MOE_PEAK_PREDICTED[0]}-{MOE_PEAK_PREDICTED[1]} bytes; {free} bytes free for the "
          f"step-{MOE_CUT} checkpoint; {torch.cuda.memory_allocated()} bytes held on the card "
          "before the run", flush=True)

    # the final checkpoint of a run is replaced by the fingerprint of its
    # state: two 40 GB checkpoints do not fit the disk beside each other
    prints = {}

    class FingerprintAtEnd(CheckpointManager):
        def save(self, step, tree):
            if step == TRAIN_STEPS:
                prints[self.dir] = fingerprint(torch, tree)
                return None
            return super().save(step, tree)

    dispatch, drops = moe._dispatch, []

    def counting(top_e, e_count, capacity, e_first=0):
        order, keep, slot = dispatch(top_e, e_count, capacity, e_first)
        drops.append((~keep).sum())
        return order, keep, slot

    manager = loop.CheckpointManager
    loop.CheckpointManager = FingerprintAtEnd
    try:
        # the main path: 4 steps through the training loop
        whole_dir, cut_dir = str(CKPT_ROOT / "whole"), str(CKPT_ROOT / "cut")
        moe._dispatch = counting
        ops.reset_launch_counts()  # counts start at 0 just before the training path
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            whole, log = train_cut(cfg, run, dev, whole_dir)
        finally:
            moe._dispatch = dispatch
        wall = time.perf_counter() - t0
        launches = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        tokens = TRAIN_BATCH * MOE_SEQ
        dropped = [int(d) for d in drops]
        print(f"[train-moe] {TRAIN_STEPS} steps in {wall} s (the end state's fingerprint "
              "included): step ms " + json.dumps([t * 1e3 for t in whole.step_times])
              + ", tokens/s " + json.dumps([tokens / t for t in whole.step_times])
              + ", losses " + json.dumps(whole.losses) + ", grad norms "
              + json.dumps(whole.grad_norms) + f", peak device memory {peak} bytes (predicted "
              f"{MOE_PEAK_PREDICTED[0]}-{MOE_PEAK_PREDICTED[1]}); loop log: "
              + " | ".join(log), flush=True)
        check(whole.steps == TRAIN_STEPS and all(math.isfinite(x) for x in
                                                 whole.losses + whole.grad_norms),
              "MoE training: a loss or gradient norm is not finite")
        check(peak < torch.cuda.get_device_properties(0).total_memory,
              f"MoE training peak {peak} bytes")
        print(f"[train-moe] assignments dropped at capacity ({cap} a expert): "
              f"{sum(dropped)} over {len(dropped)} layer forwards (remat runs each twice) of "
              f"{TRAIN_MICRO * MOE_SEQ * cfg.moe.top_k} assignments, "
              f"{sum(dropped) / len(dropped)} a forward; per forward of the first "
              f"microbatch's layers: " + json.dumps(dropped[:cfg.n_layers]), flush=True)
        print("[train-moe] launches in the run: " + json.dumps(
            {k: launches[k] for k in MOE_PER_STEP}), flush=True)
        for name, n in MOE_PER_STEP.items():
            check(launches[name] == n * TRAIN_STEPS, f"MoE training: {name} launched "
                  f"{launches[name]} times in {TRAIN_STEPS} steps, not {n * TRAIN_STEPS}")
        gc.collect()
        torch.cuda.empty_cache()

        # a run killed at step 2 resumes from its step-2 checkpoint and ends
        # where the uninterrupted run ended
        t0 = time.perf_counter()
        try:
            train_cut(cfg, run, dev, cut_dir, fail_at_step=MOE_CUT)
            fail(f"fail_at_step {MOE_CUT} did not stop the run")
        except RuntimeError as exc:
            if str(exc) != f"injected node failure at step {MOE_CUT}":
                raise
        latest = CheckpointManager(cut_dir).latest_step()
        gc.collect()
        torch.cuda.empty_cache()
        resumed, _ = train_cut(cfg, run, dev, cut_dir)
        check(latest == MOE_CUT and resumed.resumed_from == MOE_CUT
              and resumed.steps == TRAIN_STEPS - MOE_CUT,
              f"the run resumed from {resumed.resumed_from}, not from step {MOE_CUT}")
        check(resumed.losses == whole.losses[MOE_CUT:], f"resumed losses {resumed.losses} != "
              f"{whole.losses[MOE_CUT:]}")
        check(prints[cut_dir] == prints[whole_dir], "the resumed run's end state differs "
              "from the uninterrupted one's: " + json.dumps(
                  [k for k in prints[whole_dir] if prints[cut_dir][k] != prints[whole_dir][k]]))
        print(f"[train-moe] the injected failure at step {MOE_CUT} raised and left its "
              f"step-{MOE_CUT} checkpoint; the rerun resumed from it, its losses "
              f"{resumed.losses} equal the uninterrupted run's bit for bit, and its end state "
              f"has the uninterrupted one's fingerprint in all {len(prints[whole_dir])} leaves "
              f"({time.perf_counter() - t0} s with the checkpoint)", flush=True)
    finally:
        loop.CheckpointManager = manager
        moe._dispatch = dispatch
        shutil.rmtree(CKPT_ROOT, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()

    # the same step twice from the same state, bit for bit (the first state
    # waits on the host); the second step profiled, the MoE layer's parts as
    # profiler ranges (their forward and remat passes: the backward runs
    # outside them)
    step_fn, _ = make_train_step(cfg, run)
    batch = to_device(batch_at(SynthSpec(vocab=cfg.vocab, seq_len=MOE_SEQ, batch=TRAIN_BATCH,
                                         seed=TRAIN_SEED), 0), dev)
    kept = None
    for i in range(2):
        model, opt_state = init_train_state(cfg, run, seed=TRAIN_SEED, device=dev)
        if i == 0:
            model, opt_state, m0 = step_fn(model, opt_state, batch)
            kept = [t.detach().cpu() for _, t in tree_flatten({"params": model.tree(),
                                                               "opt": opt_state})]
        else:
            out = {}

            def one_step():
                out["state"] = step_fn(model, opt_state, batch)

            with moe_ranges(torch) as ranges:
                pwall, busy, copy, kern, spans = profiled(torch, one_step, ranges)
            model, opt_state, m1 = out.pop("state")
            leaves = [t for _, t in tree_flatten({"params": model.tree(), "opt": opt_state})]
            check(len(leaves) == len(kept) and all(
                torch.equal(a.detach().cpu(), b) for a, b in zip(leaves, kept)),
                "granite-MoE: the same step from the same state gave other params or "
                "optimizer state")
            check(float(m0["loss"]) == float(m1["loss"]), "granite-MoE: repeated step loss")
            del leaves
        del model, opt_state
    del kept
    gc.collect()
    torch.cuda.empty_cache()
    attn, gemm, moved = trace_split(kern, True)
    print(f"[train-moe] a step repeated from the same state gave params, AdamW moments and "
          f"loss ({float(m1['loss'])}) equal bit for bit", flush=True)
    print(f"[train-moe-trace] one step, profiled: wall {pwall} ms, device kernels {busy} ms "
          f"(attention kernels {attn} ms, GEMMs {gemm} ms, sort / gather / scatter / index "
          f"kernels (MoE routing, grouping, combine and their backward) {moved} ms, other "
          f"{busy - attn - gemm - moved} ms), device copies {copy} ms, device idle "
          f"{100 * (1 - (busy + copy) / pwall)}%; forward and remat passes of the MoE layer "
          "(host ms, device ms): " + json.dumps(spans) + "; top: "
          + ", ".join(f"{k[:50]} {t}" for t, k in kern[:10]), flush=True)

    # check 2: the kernels against the plain attention on one microbatch
    model = init_model(cfg, seed=TRAIN_SEED, device=dev, trainable=True)
    moe_step_vs_plain(torch, ops, cfg, model, dev)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return {k: launches[k] for k in MOE_PER_STEP}


# --------------------------------------------------------------------------- #
# phase 4g: the model mesh, four shards emulated on the card                    #
# --------------------------------------------------------------------------- #

# granite-MoE served over one data row of four model shards on the one card,
# expert-parallel (40 experts, ten a shard) with split-S decode against a
# cache sharded over the shards, against the same context (tp 4: vocab padded
# to 49,184) with no mesh.  Layer 0's expert-parallel MoE on the model's own
# inputs within MOE_TOL (2^-5) of the largest |y| of moe_ffn's (the shards'
# parts add in another order in bf16), its kept and dropped assignments
# exact; one split-S decode step of layer 0 within SPLIT_TOL of the dense
# cached path's largest |out| (the bf16 limit of tests/test_torch_attention.py:
# split-S rounds p to bf16 before the PV product, as the reference does), its
# written cache bit for bit.
MESH_TP = 4
SPLIT_TOL = 2e-2
# smollm trained over four data rows (one step of 8 x 4,096 tokens, remat
# full) against one step with microbatch 2 and no mesh: 4 rows x 32 layers x
# 2 forwards (remat) and 4 x 32 of each backward kernel, in each step
MESH_DP = 4
MESH_STEP = {"flash_attention": 256, "flash_attention_wgmma": 256,
             "flash_attention_bwd_dq": 128, "flash_attention_bwd_dkdv": 128,
             "flash_attention_bwd_dq_wgmma": 128, "flash_attention_bwd_dkdv_wgmma": 128}


def mesh_generate(torch, cfg, model, pre, dec, prompt, feed=None):
    """A prefill + N_TOKENS decode steps, greedy or fed ``feed`` (B,
    N_TOKENS) → (tokens, each step's last logits (the prefill's first),
    prefill ms, ms a decode token, the cache), walls synchronized on every
    card."""
    def sync():
        for d in range(torch.cuda.device_count()):
            torch.cuda.synchronize(d)

    sync()
    t0 = time.perf_counter()
    with torch.no_grad():
        logits, cache = pre(model, prompt)
        sync()
        t1 = time.perf_counter()
        outs, steps = [], [logits]
        for t in range(N_TOKENS):
            nxt = (logits[..., :cfg.vocab].argmax(-1).to(torch.int32) if feed is None
                   else feed[:, t])
            outs.append(nxt)
            pos = torch.tensor(prompt.shape[1] + t, dtype=torch.int32, device=prompt.device)
            logits, cache = dec(model, cache, nxt[:, None], pos)
            steps.append(logits)
        sync()
    t2 = time.perf_counter()
    return (torch.stack(outs, -1), steps, (t1 - t0) * 1e3, (t2 - t1) * 1e3 / N_TOKENS, cache)


MESH_SERVE_LAYERS = 16  # of granite's 32, so that the whole script keeps to its time


def mesh_serving(torch, devices):
    """Phase 4g (a): granite-MoE at full width cut to MESH_SERVE_LAYERS
    layers served over ``make_mesh(1, 4, devices=devices)`` (``[cuda:0] *
    4`` in the smoke), expert-parallel, its caches by kv heads (8 over 4
    shards, as the reference places them), each decode step the split-S
    arithmetic on each shard's heads."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import ShardCtx, attention, blocks, init_model, moe
    from repro_torch.serve import make_serve_fns

    cfg = dataclasses.replace(get_config("granite_moe_3b_a800m"), n_layers=MESH_SERVE_LAYERS)
    ctx = ShardCtx(tp=MESH_TP)
    e_pad, vocab = cfg.moe.padded_experts(MESH_TP), cfg.padded_vocab(MESH_TP)
    e_loc = e_pad // MESH_TP
    mesh = make_mesh(1, MESH_TP, devices=devices)
    dev = mesh.first
    t0 = time.perf_counter()
    model = init_model(cfg, ctx, seed=SERVE_SEED, device=dev)
    torch.cuda.synchronize()
    nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    print(f"[mesh-serve] {cfg.name} at ShardCtx(tp={MESH_TP}): {e_pad} experts ({e_loc} a "
          f"shard), vocab padded to {vocab}, {nbytes} bytes, made in "
          f"{time.perf_counter() - t0} s; mesh {mesh.shape} over {[str(d) for d in mesh.devices]}",
          flush=True)
    check(model.embed.tok.shape[1] == vocab and e_pad == 40, "granite at tp 4: the padded shapes")
    rng = np.random.default_rng(SERVE_SEED)
    prompt = torch.tensor([rng.integers(0, cfg.vocab, 1024).tolist()], device=dev)

    plain = make_serve_fns(cfg, ctx, capacity=2048)[:2]
    meshed = make_serve_fns(cfg, ctx, mesh=mesh, capacity=2048, use_ep=True)[:2]
    toks0, _, pre0, dec0, _ = mesh_generate(torch, cfg, model, *plain, prompt)
    # one decode step counted: the split-S calls on each shard's heads and
    # each shard's experts
    calls = {"split": 0, "ep": []}
    split_fn, ep_fn = attention._blocks_decode, moe.moe_ffn_ep

    def count_split(*args):
        calls["split"] += 1
        return split_fn(*args)

    def record_ep(params_local, cfg_, x, ctx_, shard):
        calls["ep"].append((shard, params_local["w_up"].device, params_local["w_up"].shape[0],
                            x.device))
        return ep_fn(params_local, cfg_, x, ctx_, shard)

    toks1, steps1, pre1, dec1, cache = mesh_generate(torch, cfg, model, *meshed, prompt)
    last1 = steps1[-1]
    kv = cache["groups"]["p0_attn"]
    h_loc = cfg.n_kv_heads // MESH_TP
    check(isinstance(kv, attention.ShardedKVCache) and kv.dim == 1 and len(kv.k) == MESH_TP
          and all(kv.k[s].device == mesh.device(0, s) and kv.k[s].shape[-3] == h_loc
                  and kv.k[s].shape[-2] == 2048 for s in range(MESH_TP)),
          "the mesh cache is not placed over the four model shards by kv heads")
    attention._blocks_decode, moe.moe_ffn_ep = count_split, record_ep
    try:
        step_tok = toks1[:, -1:]
        with torch.no_grad():
            meshed[1](model, cache, step_tok, torch.tensor(1024 + N_TOKENS, dtype=torch.int32,
                                                           device=dev))
    finally:
        attention._blocks_decode, moe.moe_ffn_ep = split_fn, ep_fn
    layers = cfg.n_layers
    check(calls["split"] == layers * MESH_TP, f"a decode step ran split-S on a shard's heads "
          f"{calls['split']} times, not {MESH_TP} in each of {layers} attention layers")
    check(len(calls["ep"]) == layers * MESH_TP and all(
        dev_w == mesh.device(0, s) and n == e_loc and dev_x == mesh.device(0, s)
        for s, dev_w, n, dev_x in calls["ep"]) and [c[0] for c in calls["ep"]]
        == list(range(MESH_TP)) * layers,
        "a decode step's expert-parallel calls: not four shards a layer, each on its own "
        "device with its ten experts")
    print(f"[mesh-serve] one decode step: split-S on each shard's {h_loc} kv heads "
          f"{calls['split']} times ({MESH_TP} a layer), {len(calls['ep'])} expert-parallel "
          f"shard calls ({MESH_TP} a layer, each with {e_loc} experts on its shard's device)",
          flush=True)

    # a whole repeat in a fresh mesh: tokens and last logits bit for bit
    mesh2 = make_mesh(1, MESH_TP, devices=devices)
    toks2, steps2, pre2, dec2, _ = mesh_generate(
        torch, cfg, model, *make_serve_fns(cfg, ctx, mesh=mesh2, capacity=2048, use_ep=True)[:2],
        prompt)
    check(torch.equal(toks2, toks1) and torch.equal(steps2[-1], last1),
          "a repeat in a fresh mesh gave other tokens or last logits")
    toks3, _, pre3, dec3, _ = mesh_generate(torch, cfg, model, *plain, prompt)
    check(torch.equal(toks3, toks0), "the no-mesh run repeated other tokens")
    check(bool(torch.isfinite(last1.float()).all()) and last1.shape[-1] == vocab,
          "mesh logits not finite or not of the padded vocab")
    agree = int((toks1 == toks0).sum())
    print(f"[mesh-serve] a fresh mesh repeated the tokens and last logits bit for bit; "
          f"{agree} of {N_TOKENS} generated tokens equal the no-mesh run's (random weights "
          f"route near ties); in the order run: prefill 1,024 tokens, no mesh {pre0} ms, mesh "
          f"{pre1} / {pre2} ms, no mesh {pre3} ms; decode: no mesh {dec0} ms a token, mesh "
          f"{dec1} / {dec2}, no mesh {dec3}", flush=True)

    # layer 0 on the model's own inputs: the EP MoE and a split-S decode step
    seen = {}
    sharded_fn, attn_fn = blocks.moe_ffn_sharded, blocks.attention_block

    def capture_moe(params, cfg_, x, ctx_, mesh_):
        seen.setdefault("moe", (params, x.detach().clone()))
        return sharded_fn(params, cfg_, x, ctx_, mesh_)

    def capture_attn(params, cfg_, x, positions, **kw):
        seen.setdefault("attn", (params, x.detach().clone(), positions, kw))
        return attn_fn(params, cfg_, x, positions, **kw)

    blocks.moe_ffn_sharded, blocks.attention_block = capture_moe, capture_attn
    try:
        with torch.no_grad():
            _, cache = meshed[0](model, prompt)
            seen.pop("attn")
            meshed[1](model, cache, toks1[:, :1], torch.tensor(1024, dtype=torch.int32,
                                                             device=dev))
    finally:
        blocks.moe_ffn_sharded, blocks.attention_block = sharded_fn, attn_fn
    params_ep, x = seen["moe"]
    check(all(params_ep["w_up"][s].device == mesh.device(0, s) and
              params_ep["w_up"][s].shape[0] == e_loc for s in range(MESH_TP)),
          "layer 0's expert slices are not on their shards")
    full = model.groups["p0_attn"].layer(0)["moe"]
    T = x.shape[0] * x.shape[1]
    cap = moe.expert_capacity(cfg, T)
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.no_grad():
            y_ep, aux_ep = moe.moe_ffn_sharded(params_ep, cfg, x, ctx, mesh)
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    torch.cuda.synchronize()
    with torch.no_grad():
        y_g, aux_g = moe.moe_ffn(full, cfg, x, ctx)
        _, top_e, _ = moe._route(full, cfg, x.reshape(T, -1), e_pad)
        _, top_e0, _ = moe._route({"router": full["router"].to(mesh.device(0, 0))}, cfg,
                                  x.reshape(T, -1), e_pad)
    check(torch.equal(top_e, top_e0), "layer 0: a shard routed other experts than moe_ffn")
    order, keep, _ = moe._dispatch(top_e, e_pad, cap)
    dropped = set(order[~keep].tolist())
    kept = set()
    for s in range(MESH_TP):
        o_s, k_s, _ = moe._dispatch(top_e, e_loc, cap, e_first=s * e_loc)
        kept |= set(o_s[k_s].tolist())
    check(kept == set(order[keep].tolist()) and dropped == set(range(T * cfg.moe.top_k)) - kept,
          "layer 0: the shards kept other assignments than moe_ffn")
    err = float((y_ep.float() - y_g.float()).abs().max())
    scale = float(y_g.float().abs().max())
    check(err <= MOE_TOL * scale, f"layer 0: moe_ffn_sharded vs moe_ffn max |err| {err} over "
          f"{MOE_TOL} of the largest |y| {scale}")
    aux_err = {k: abs(float(aux_ep[k]) - float(aux_g[k])) / abs(float(aux_g[k])) for k in aux_g}
    print(f"[mesh-serve] layer 0, {T} tokens, capacity {cap}: moe_ffn_sharded over "
          f"{MESH_TP} shards ran under set_sync_debug_mode('error') with no host "
          f"synchronization; against moe_ffn at the same context: {len(kept)} kept and "
          f"{len(dropped)} dropped assignments equal, max |err| {err} (limit {MOE_TOL * scale}), "
          f"aux relative errors {aux_err}", flush=True)

    a_params, a_x, a_pos, a_kw = seen["attn"]
    sharded = a_kw["cache"]
    check(isinstance(sharded, attention.ShardedKVCache), "layer 0's decode cache not sharded")
    with torch.no_grad():
        out_s, cache_s = attention.attention_block(a_params, cfg, a_x, a_pos, **a_kw)
        out_d, cache_d = attention.attention_block(
            a_params, cfg, a_x, a_pos, window=a_kw["window"], cache=sharded.gathered(), ctx=ctx)
    gathered = cache_s.gathered()
    check(torch.equal(gathered.k, cache_d.k) and torch.equal(gathered.v, cache_d.v)
          and int(gathered.pos) == int(cache_d.pos), "layer 0: split-S wrote another cache")
    err = float((out_s.float() - out_d.float()).abs().max())
    scale = float(out_d.float().abs().max())
    check(err <= SPLIT_TOL * scale, f"layer 0: split-S decode vs the dense cached path max "
          f"|err| {err} over {SPLIT_TOL} of the largest |out| {scale}")
    with torch.no_grad():  # the same cache split by slots: the same values, bit for bit
        out_b, cache_b = attention.attention_block(
            a_params, cfg, a_x, a_pos, **dict(a_kw, cache=attention.ShardedKVCache.split(
                sharded.gathered(), [mesh.device(0, s) for s in range(MESH_TP)])))
    check(torch.equal(out_b, out_s) and torch.equal(cache_b.gathered().k, gathered.k),
          "layer 0: split-S on each shard's heads differs from split-S over the slots")
    print(f"[mesh-serve] layer 0, one decode step at position 1,024: split-S on each of "
          f"{MESH_TP} shards' kv heads against the dense cached path, max |err| {err} (limit "
          f"{SPLIT_TOL * scale}), and bit for bit split-S over the cache's slots; the written "
          "cache equal bit for bit", flush=True)
    del model, cache, seen
    gc.collect()
    torch.cuda.empty_cache()


SLOT_SERVE_MODEL = "smollm_360m"  # 5 kv heads: over four shards its caches lie by slots


def slot_serving(torch, devices):
    """Phase 4g (c): SLOT_SERVE_MODEL at full width and depth served over
    ``make_mesh(1, 4, devices=devices)`` with whole weights: its kv heads
    do not divide 4, so ``lm.init_cache`` places each KV cache by slots
    (split-S, 512 of the 2,048 a shard).  A 1,024-token prefill, whose new
    k and v each layer writes where their slots lie (``_write_slots``, once
    a layer), and N_TOKENS greedy decode steps (``_split_s_decode``, once a
    layer a step) against the no-mesh decode fed the same tokens: each
    step's logits within TP_TOL of the largest |logit|, each shard's cache
    bytes the reckoning after the prefill and after the last step; the walls
    beside the no-mesh run's and the same mesh's with the caches whole on
    the first device."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import ShardCtx, attention, init_model
    from repro_torch.serve import make_serve_fns

    cfg = get_config(SLOT_SERVE_MODEL)
    ctx = ShardCtx(tp=MESH_TP)
    mesh = make_mesh(1, MESH_TP, devices=devices)
    dev = mesh.first
    model = init_model(cfg, ctx, seed=SERVE_SEED, device=dev)
    prompt = torch.as_tensor(np.random.default_rng(SERVE_SEED + 5).integers(
        0, cfg.vocab, (1, 1024)), device=dev)
    pre, dec = make_serve_fns(cfg, ctx, mesh=mesh, capacity=TP_CAPACITY)[:2]
    seen, calls = [], {"_write_slots": 0, "_split_s_decode": 0}
    fns = {name: getattr(attention, name) for name in calls}

    def counting(name):
        def fn(*args):
            calls[name] += 1
            return fns[name](*args)
        return fn

    for name in calls:
        setattr(attention, name, counting(name))
    try:
        toks, steps, pre_m, dec_m, cache = mesh_generate(
            torch, cfg, model, checked_prefill(torch, cfg, pre, mesh, TP_CAPACITY, seen), dec,
            prompt)
    finally:
        for name, fn in fns.items():
            setattr(attention, name, fn)
    layers = cfg.n_layers
    kv = cache["groups"]["p0_attn"]
    check(isinstance(kv, attention.ShardedKVCache) and kv.dim == 2 and all(
        t.shape[-2] == TP_CAPACITY // MESH_TP for t in kv.k),
        f"{cfg.name}: the caches are not placed over the shards by slots")
    check(calls == {"_write_slots": layers, "_split_s_decode": layers * N_TOKENS},
          f"{cfg.name}: the prefill and the decode steps made {calls}, not {layers} slot writes "
          f"and {layers * N_TOKENS} split-S decodes")
    last = cache_cards(torch, cfg, cache, mesh, 1, TP_CAPACITY, "after the last decode step")
    del cache
    _, want, pre0, dec0, _ = mesh_generate(
        torch, cfg, model, *make_serve_fns(cfg, ctx, capacity=TP_CAPACITY)[:2], prompt, feed=toks)
    errs = [logits_err(torch, a[:, None], b[:, None]) for a, b in zip(steps, want)]
    worst = max(e / sc for e, sc in errs)
    pre_wc, dec_wc, wc_err = whole_cache_decode(
        torch, cfg, model, whole_cache_prefill(torch, cfg, ctx, mesh, TP_CAPACITY), dec, prompt,
        toks, steps)
    check(worst <= TP_TOL and wc_err <= TP_TOL, f"{cfg.name}: the decode over the slots moved "
          f"{worst} of the largest |logit| from the no-mesh decode's and {wc_err} from the caches "
          f"whole on the first device, over {TP_TOL}")
    print(f"[mesh-serve] {cfg.name} at full width and depth over {MESH_TP} shards, its caches by "
          f"slots ({cfg.n_kv_heads} kv heads; {TP_CAPACITY // MESH_TP} slots a shard): a 1,024-token "
          f"prefill ({calls['_write_slots']} slot writes) and {N_TOKENS} greedy decode steps "
          f"({calls['_split_s_decode']} split-S decodes) against the no-mesh decode fed the same "
          f"tokens, worst step's max |err| over its largest |logit| {worst} (limit {TP_TOL}); each "
          f"shard's cache bytes the reckoning after the prefill {seen[-1]} and after the last "
          f"step {last}; prefill {pre_m} ms, no mesh {pre0} ms, the caches whole {pre_wc} ms; "
          f"decode {dec_m} ms a token, no mesh {dec0} ms, the caches whole {dec_wc} ms (their "
          f"logits {wc_err} of the largest from the slots')", flush=True)
    del model
    gc.collect()
    torch.cuda.empty_cache()


def mesh_training(torch, ops, devices):
    """Phase 4g (b): smollm at full width, one step over ``make_mesh(4, 1,
    devices=devices)`` (``[cuda:0] * 4`` in the smoke) and one step with
    microbatch 2 and no mesh from the same state, each twice: bit for bit;
    returns the attention launches of the four steps."""
    from repro_torch.configs import RunConfig, get_config, get_shape
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import SynthSpec, batch_at
    from repro_torch.data.loader import to_device
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train.trainstep import init_train_state, make_train_step

    cfg = get_config("smollm_360m")
    base = get_shape("train_4k")
    shape = ShapeConfig(base.name, base.kind, base.seq_len, TRAIN_BATCH)
    mesh = make_mesh(MESH_DP, 1, devices=devices)
    dev = mesh.first
    runs = {"mesh": RunConfig(model=cfg, shape=shape, dp=MESH_DP, tp=1, remat="full"),
            "microbatch": RunConfig(model=cfg, shape=shape, dp=1, tp=1, remat="full",
                                    microbatch=TRAIN_BATCH // MESH_DP)}
    batch = to_device(batch_at(SynthSpec(vocab=cfg.vocab, seq_len=shape.seq_len,
                                         batch=TRAIN_BATCH, seed=0), 0), dev)
    out, launches, total = {}, {}, {k: 0 for k in TRAINING}
    # in turns (mesh, microbatch, microbatch, mesh): the first of each is
    # kept for the bit-for-bit check, the second must repeat it
    for name in ("mesh", "microbatch", "microbatch", "mesh"):
        run = runs[name]
        step_fn, _ = make_train_step(cfg, run, mesh=mesh if name == "mesh" else None)
        model, opt_state = init_train_state(cfg, run, seed=TRAIN_SEED, device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        model, opt_state, metrics = step_fn(model, opt_state, batch)
        loss = float(metrics["loss"])
        ms = (time.perf_counter() - t0) * 1e3
        launches[name] = ops.launch_counts()
        for k in TRAINING:
            total[k] += launches[name][k]
        peak = torch.cuda.max_memory_allocated()
        state = ({"params": model.tree(), "opt": opt_state}, metrics["loss"])
        if name in out:
            check(tree_bytes_equal(torch, state[0], out[name][0]) and torch.equal(
                state[1], out[name][1]), f"the {name} step repeated gave another state")
        else:
            out[name] = state
        del state
        print(f"[mesh-train] {cfg.name}, one step of {TRAIN_BATCH} x {shape.seq_len} tokens "
              f"({name}: " + (f"{MESH_DP} data rows on {[str(d) for d in mesh.devices]}"
                              if name == "mesh" else
                              f"microbatch {run.microbatch}, no mesh")
              + f"): {ms} ms, loss {loss}, peak device memory {peak} bytes; launches "
              + json.dumps({k: launches[name][k] for k in MESH_STEP}), flush=True)
        for k, n in MESH_STEP.items():
            check(launches[name][k] == n, f"{name} step: {k} launched {launches[name][k]} "
                  f"times, not {n}")
        check(math.isfinite(loss), f"{name} step: loss not finite")
        del model, opt_state
    (a, la), (b, lb) = out["mesh"], out["microbatch"]
    check(tree_bytes_equal(torch, a, b) and torch.equal(la, lb), "the step over four data rows "
          "is not the microbatch-2 step bit for bit (params, moments or loss)")
    print("[mesh-train] the step over four data rows equals the microbatch-2 step bit for bit: "
          "params, both moments, the step count and the loss", flush=True)
    del out, a, b
    gc.collect()
    torch.cuda.empty_cache()
    return total


def mesh_phase(torch, ops, devices):
    """Phase 4g: the model mesh over four ``devices`` (``[cuda:0] * 4`` in
    the smoke: four shards emulated on the card); returns its attention
    launches."""
    t0 = time.perf_counter()
    ops.reset_launch_counts()  # counts start at 0 just before the phase's paths
    mesh_serving(torch, devices)
    slot_serving(torch, devices)
    served = ops.launch_counts()
    attn = {k: v for k, v in served.items() if k.startswith("flash_attention")}
    check(not any(attn.values()), f"the mesh serving path launched attention kernels {attn}; "
          "the cached branch and split-S are plain paths")
    launches = mesh_training(torch, ops, devices)
    print(f"[mesh] flash_attention launches in phase 4g: " + json.dumps(launches)
          + f"; phase took {time.perf_counter() - t0} s", flush=True)
    return launches


# Phase 4h: the train state stored in slices over four data rows emulated on
# the card (each row keeps its quarter of every sliced leaf of the float32
# weights and AdamW moments, and gathers a layer's weights as it runs it).
# (a) smollm at full width and depth, one step of 8 x 4,096 tokens sliced and
# one replicated over the same mesh from the same seed, in turns: the launches
# of each step are MESH_STEP's.  (b) qwen3_8b at full width cut to 8 of its 36
# layers: its whole state (weights, gradients, two moments in float32) is
# 131 GB, past one card's 80 GB, and 44.6 GB at 8 layers, 11.15 GB a row.
# One sequence of 4,096 tokens a row, two steps, then the same two again from
# the same seed (the second traced); a step launches 4 rows x 8 layers x 2
# forwards (remat) and 4 x 8 of each backward kernel (fsdp_launches).
FSDP_DP = 4
FSDP_QWEN_LAYERS = 8
FSDP_QWEN_BATCH = 4
FSDP_QWEN_STEPS = 2
FSDP_PEAK_LIMIT = 72e9


def fsdp_launches(layers):
    """The attention launches of one 4h (b) step at ``layers`` layers."""
    fwd, bwd = FSDP_DP * layers * 2, FSDP_DP * layers
    return {"flash_attention": fwd, "flash_attention_wgmma": fwd,
            "flash_attention_bwd_dq": bwd, "flash_attention_bwd_dkdv": bwd,
            "flash_attention_bwd_dq_wgmma": bwd, "flash_attention_bwd_dkdv_wgmma": bwd}



def placed_equal(torch, placed, whole) -> bool:
    """A placed tree (``fsdp.Sliced`` leaves) against a whole one, leaf by
    leaf gathered onto the whole leaf's device: bit for bit."""
    from repro_torch.models.base import tree_flatten

    fa, fb = tree_flatten(placed), tree_flatten(whole)
    return [p for p, _ in fa] == [p for p, _ in fb] and all(
        torch.equal(x.whole(y.device), y.detach()) for (_, x), (_, y) in zip(fa, fb))


def placed_fingerprint(torch, tree):
    """``fingerprint`` of each part of each sliced leaf."""
    from repro_torch.models.base import keystr, tree_flatten

    return {f"{keystr(path)}[{r}][{s}]": v
            for path, leaf in tree_flatten(tree)
            for r, row in enumerate(leaf.parts) for s, part in enumerate(row)
            for v in fingerprint(torch, {"p": part}).values()}


def sliced_quarters(model, rows) -> bool:
    """Every leaf sliced over the rows holds 1/rows of itself a row."""
    from repro_torch.models.base import tree_flatten

    return all(all(p.numel() * rows == leaf.numel() for p in leaf.all_parts())
               for _, leaf in tree_flatten(model.tree()) if leaf.dim is not None)


def fsdp_smollm(torch, ops, devices):
    """Phase 4h (a): smollm's step over four rows, sliced and replicated, in
    turns; → the attention launches of the four steps."""
    from repro_torch.configs import RunConfig, get_config, get_shape
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import SynthSpec, batch_at
    from repro_torch.data.loader import to_device
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.base import ShardCtx
    from repro_torch.train.trainstep import (init_placed_state, init_train_state,
                                             make_train_step, placement_bytes, row_state_bytes)

    cfg = get_config("smollm_360m")
    base = get_shape("train_4k")
    shape = ShapeConfig(base.name, base.kind, base.seq_len, TRAIN_BATCH)
    mesh = make_mesh(FSDP_DP, 1, devices=devices)
    dev = mesh.first
    run = RunConfig(model=cfg, shape=shape, dp=FSDP_DP, tp=1, remat="full")
    step_fn, ctx = make_train_step(cfg, run, mesh=mesh)
    batch = to_device(batch_at(SynthSpec(vocab=cfg.vocab, seq_len=shape.seq_len,
                                         batch=TRAIN_BATCH, seed=0), 0), dev)
    cards = sorted({d.index for d in mesh.devices})
    out, total = {}, {k: 0 for k in TRAINING}
    for name in ("sliced", "replicated", "replicated", "sliced"):
        torch.cuda.synchronize()
        if name == "sliced":
            model, opt_state = init_placed_state(cfg, run, ctx, mesh, seed=TRAIN_SEED)
        else:
            model, opt_state = init_train_state(cfg, run, ctx, seed=TRAIN_SEED, device=dev)
        torch.cuda.synchronize()
        held = [torch.cuda.memory_allocated(i) for i in cards]
        for i in cards:
            torch.cuda.reset_peak_memory_stats(i)
        if name == "sliced":
            rows = row_state_bytes(model, opt_state)
            want = placement_bytes(cfg, ShardCtx(dp=FSDP_DP), arrays=3)[1]
            check(rows == [want] * FSDP_DP and sliced_quarters(model, FSDP_DP),
                  f"4h (a): the rows hold {rows} bytes of weights and moments, not the "
                  f"placements' {want} each, or a sliced leaf not in quarters")
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        model, opt_state, metrics = step_fn(model, opt_state, batch)
        loss = float(metrics["loss"])
        ms = (time.perf_counter() - t0) * 1e3
        launches = ops.launch_counts()
        peak = [torch.cuda.max_memory_allocated(i) for i in cards]
        for k in TRAINING:
            total[k] += launches[k]
        for k, n in MESH_STEP.items():
            check(launches[k] == n, f"4h (a) {name} step: {k} launched {launches[k]} times, "
                  f"not {n}")
        check(math.isfinite(loss), f"4h (a) {name} step: loss not finite")
        state = ({"params": model.tree(), "opt": {k: opt_state[k] for k in ("mu", "nu")}},
                 metrics["loss"], metrics["grad_norm"])
        if name in out:
            same = (placed_fingerprint(torch, state[0]) == placed_fingerprint(torch, out[name][0])
                    if name == "sliced" else tree_bytes_equal(torch, state[0], out[name][0]))
            check(same and torch.equal(state[1], out[name][1]),
                  f"4h (a): the {name} step repeated gave another state")
        else:
            out[name] = state
        del state
        print(f"[fsdp] {cfg.name}, one step of {TRAIN_BATCH} x {shape.seq_len} tokens over "
              f"{FSDP_DP} data rows on {[str(d) for d in mesh.devices]} ({name}): {ms} ms, "
              f"loss {loss}, grad_norm {float(metrics['grad_norm'])}; device memory held "
              f"before the step {held} bytes, peak {peak} bytes"
              + (f"; bytes of weights and moments each row holds {rows}" if name == "sliced"
                 else ""), flush=True)
        del model, opt_state, metrics
    (a, la, ga), (b, lb, gb) = out["sliced"], out["replicated"]
    check(placed_equal(torch, a, b) and torch.equal(la, lb) and torch.equal(ga, gb),
          "4h (a): the sliced step is not the replicated step bit for bit (params, moments, "
          "loss or grad_norm)")
    print("[fsdp] the sliced step equals the replicated step bit for bit: params, both "
          "moments, the loss and grad_norm", flush=True)
    del out, a, b
    gc.collect()
    torch.cuda.empty_cache()
    return total


def step_split(torch, prof):
    """A traced step's device time split into the gathers' copies, their
    gradient adds, GEMMs, attention and the rest (ms)."""
    from torch.autograd import DeviceType

    avg = prof.key_averages()
    spans = {e.key: e.device_time_total / 1e3 for e in avg
             if e.key in ("fsdp_gather", "fsdp_grad_add") and e.device_type == DeviceType.CPU}
    dev = [e for e in avg if e.device_type == DeviceType.CUDA]
    split = {"attention": 0.0, "gemm": 0.0, "other": 0.0}
    others = []
    for e in dev:
        t = e.self_device_time_total / 1e3
        key = e.key.lower()
        if "attn_" in key:
            split["attention"] += t
        elif any(w in key for w in ("gemm", "nvjet", "cutlass", "xmma", "sm90_")):
            split["gemm"] += t
        else:
            split["other"] += t
            others.append((t, e.count, e.key[:90]))
    split["device"] = sum(split.values())
    split.update(spans)
    split["other less the gathers and adds"] = split["other"] - sum(spans.values())
    split["largest other kernels (ms, launches, name)"] = sorted(others, reverse=True)[:8]
    return split


def fsdp_qwen(torch, ops, devices, layers=FSDP_QWEN_LAYERS, steps=FSDP_QWEN_STEPS,
              repeat=True, peak_limit=FSDP_PEAK_LIMIT):
    """Phase 4h (b): qwen3_8b at full width cut to ``layers`` layers, trained
    ``steps`` steps of one 4,096-token sequence a row over ``devices`` (four
    rows), the state sliced; with ``repeat``, the same steps again from the
    same seed (the last one traced), bit for bit.  → the attention launches
    of the first run."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import RunConfig, get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import SynthSpec, batch_at
    from repro_torch.data.loader import to_device
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.base import ShardCtx, param_count
    from repro_torch.models.lm import model_spec
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.trainstep import (init_placed_state, make_train_step,
                                             placement_bytes, row_state_bytes)

    cfg = dataclasses.replace(get_config("qwen3_8b"), n_layers=layers)
    seq = 4096
    shape = ShapeConfig("train_4k", "train", seq, FSDP_QWEN_BATCH)
    mesh = make_mesh(FSDP_DP, 1, devices=devices)
    run = RunConfig(model=cfg, shape=shape, dp=FSDP_DP, tp=1, remat="full")
    # no warmup, so that two steps move the loss
    opt = AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=steps)
    step_fn, ctx = make_train_step(cfg, run, mesh=mesh, opt=opt)
    data = SynthSpec(vocab=cfg.vocab, seq_len=seq, batch=FSDP_QWEN_BATCH, seed=0)
    n_params = param_count(model_spec(cfg, ctx))
    whole, per_row = placement_bytes(cfg, ShardCtx(dp=FSDP_DP))
    print(f"[fsdp] {cfg.name} cut to {layers} layers: {n_params} parameters; float32 weights, "
          f"gradients and two moments {whole} bytes whole, {per_row} a row sliced over "
          f"{FSDP_DP} rows (the placements' reckoning)", flush=True)
    cards = sorted({d.index for d in mesh.devices})
    runs, total = [], {k: 0 for k in TRAINING}
    for attempt in range(2 if repeat else 1):
        for i in cards:
            torch.cuda.reset_peak_memory_stats(i)
        t0 = time.perf_counter()
        model, opt_state = init_placed_state(cfg, run, ctx, mesh, seed=TRAIN_SEED)
        torch.cuda.synchronize()
        rows = row_state_bytes(model, opt_state)
        want = placement_bytes(cfg, ShardCtx(dp=FSDP_DP), arrays=3)[1]
        check(rows == [want] * FSDP_DP and sliced_quarters(model, FSDP_DP),
              f"4h (b): the rows hold {rows} bytes of weights and moments, not the "
              f"placements' {want} each, or a sliced leaf not in quarters")
        print(f"[fsdp] state placed in {time.perf_counter() - t0} s; bytes of weights and "
              f"moments each row holds {rows}; device memory held "
              f"{[torch.cuda.memory_allocated(i) for i in cards]}", flush=True)
        losses, metrics = [], None
        for step in range(steps):
            batch = to_device(batch_at(data, step), mesh.first)
            traced = repeat and attempt == 1 and step == steps - 1
            for i in cards:
                torch.cuda.reset_peak_memory_stats(i)
            ops.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if traced:
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    model, opt_state, metrics = step_fn(model, opt_state, batch)
                    torch.cuda.synchronize()
            else:
                model, opt_state, metrics = step_fn(model, opt_state, batch)
            loss = float(metrics["loss"])
            ms = (time.perf_counter() - t0) * 1e3
            launches = ops.launch_counts()
            peaks = [torch.cuda.max_memory_allocated(i) for i in cards]
            losses.append(metrics["loss"])
            if not traced:
                STEP_MS.setdefault("4h", []).append(ms)
            if attempt == 0:
                for k in TRAINING:
                    total[k] += launches[k]
            for k, n in fsdp_launches(layers).items():
                check(launches[k] == n, f"4h (b) step {step}: {k} launched {launches[k]} times, "
                      f"not {n}")
            check(math.isfinite(loss), f"4h (b) step {step}: loss not finite")
            check(max(peaks) < peak_limit, f"4h (b) step {step}: peak device memory "
                  f"{max(peaks)} bytes, over {peak_limit}")
            print(f"[fsdp] {cfg.name} ({layers} layers) step {step} over {FSDP_DP} rows on "
                  f"{[str(d) for d in mesh.devices]}" + (" (traced)" if traced else "")
                  + f": {ms} ms, {FSDP_QWEN_BATCH * seq / ms * 1e3} tokens/s, loss {loss}, "
                  f"grad_norm {float(metrics['grad_norm'])}, peak device memory {peaks} bytes; "
                  "launches " + json.dumps({k: launches[k] for k in fsdp_launches(layers)}),
                  flush=True)
            if traced:
                print("[fsdp] the traced step's device ms: "
                      + json.dumps(step_split(torch, prof)), flush=True)
                del prof
        check(float(losses[-1]) < float(losses[0]), f"4h (b): the loss did not fall: "
              f"{[float(x) for x in losses]}")
        runs.append((placed_fingerprint(torch, {"params": model.tree(), "mu": opt_state["mu"],
                                                "nu": opt_state["nu"]}), losses))
        del model, opt_state, metrics
        gc.collect()
        torch.cuda.empty_cache()
    if repeat:
        (fa, la), (fb, lb) = runs
        check(fa == fb and all(torch.equal(x, y) for x, y in zip(la, lb)),
              "4h (b): a repeat from the same seed gave another state or other losses")
        print(f"[fsdp] a repeat from the same seed gave the same state (a fingerprint of each "
              f"of the {len(fa)} slices) and losses {[float(x) for x in la]} bit for bit",
              flush=True)
    return total


def fsdp_phase(torch, ops, devices):
    """Phase 4h: the train state in slices over four data rows on
    ``devices`` (``[cuda:0] * 4`` in the smoke); returns its attention
    launches."""
    t0 = time.perf_counter()
    launches = fsdp_smollm(torch, ops, devices)
    for k, n in fsdp_qwen(torch, ops, devices).items():
        launches[k] += n
    print(f"[fsdp] flash_attention launches in phase 4h: " + json.dumps(launches)
          + f"; phase took {time.perf_counter() - t0} s", flush=True)
    return launches


# --------------------------------------------------------------------------- #
# phase 4j: mamba2_2p7b trained at full width and depth                         #
# --------------------------------------------------------------------------- #

# mamba2_2p7b at full width and depth (64 layers, d_model 2,560, 80 heads x
# 64, N 128, chunk 128, vocab 50,280): 2.83e9 parameters, 45.3 GB of float32
# weights, gradients and AdamW moments.  One sequence of 4,096 tokens a step
# (the reference's train_4k sequence length, its global batch 256 cut to one
# card), remat full, bf16 compute, through the train launcher.
SSD_SEQ = 4096
SSD_FLAGS = ["--arch", "mamba2_2p7b", "--full-config", "--steps", str(TRAIN_STEPS), "--batch",
             "1", "--seq", str(SSD_SEQ), "--remat", "full", "--seed", str(TRAIN_SEED)]
# predicted launches per step: 64 layers x 2 forwards (remat) of the
# intra-chunk kernel (ssd_wgmma: bf16, L 128, N 128, P 64) and the
# inter-chunk scan, and one of each tensor-core backward kernel and of
# ssd_bwd_sum a layer (bf16, L 128, N 128, P 64: bwd_route "wgmma"), none of
# the FMA ones
SSD_PER_STEP = {"ssd_chunk_scan": 128, "ssd_chunk_scan_wgmma": 128, "ssd_chunk_scan_inter": 128,
                "ssd_chunk_scan_recur": 0, "ssd_chunk_scan_bwd_state": 0,
                "ssd_chunk_scan_bwd_chunk": 0, "ssd_chunk_scan_bwd_sum": 64,
                "ssd_chunk_scan_bwd_state_wgmma": 64, "ssd_chunk_scan_bwd_chunk_wgmma": 64}
# The peak, predicted before the first run on the card: the state (16 bytes
# a parameter, 45.3 GB), the layers' remat boundaries (64 x 4,096 x 2,560 in
# bf16, 1.3 GB), one layer's recomputed activations and its SSD backward's
# scratch (h_in, g and the heads' terms: 0.5 GB), the loss head's float32
# logits and their gradient (1.6 GB), and the allocator's slack.
SSD_PEAK_PREDICTED = (47e9, 56e9)
# The C14 check: the model cut to 2 layers at full width, one microbatch of
# 1 x 4,096 tokens, through the kernels against the plain SSD (autograd of
# ssd_chunk_scan_plain under ops.local_backend("torch")).  The reference's
# initialisation leaves dt_bias and a_log at 0 (dt = softplus(0) = 0.69, A =
# 1), so a chunk of 128 keeps e^-88 of its state and no gradient crosses a
# chunk: a backward that drops the carry D_k g_k would go unseen.  The check
# sets them as Mamba-2 initialises them (dt log-uniform in [1e-3, 0.1]
# through dt_bias = softplus^-1(dt); A uniform in [1, 16] through a_log =
# log A), so a head keeps up to e^-0.13 of its state over a chunk.  Limits:
# the loss within 2e-4 relative and the gradient norm within 5e-4 (phase
# 4c's); each leaf's gradient within 2^-6 of its largest |g|, two bf16 ulps:
# y and the gradients round to bf16 at other places on the two routes, and
# each layer moves the next one's input.  Phase 4c's leaf limit, 2^-4,
# cannot see the fault: on an H100 (seed 12) the kernels read 0.0071 of
# the largest |g| (the token embedding) and the plain backward that drops
# the carry 0.039 (a_log).  No leaf may be all zeros on the kernel route
# (C14), and the carry-dropping control must cross the leaf limit.
SSD_CHECK_LAYERS = 2
SSD_GRAD_TOL = 2.0 ** -6


def mamba2_decays(torch, model, seed):
    """dt_bias and a_log of every layer as Mamba-2 initialises them, in
    place (a placed leaf in its slices), from a numpy seed."""
    import numpy as np

    from repro_torch.models.base import tree_flatten

    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for path, t in tree_flatten(model.tree()):
            put = t.copy_from if hasattr(t, "copy_from") else t.copy_  # a placed leaf: its slices
            if path[-1] == "dt_bias":
                dt = np.exp(rng.uniform(np.log(1e-3), np.log(0.1), tuple(t.shape)))
                put(torch.as_tensor(dt + np.log(-np.expm1(-dt)), dtype=t.dtype))
            elif path[-1] == "a_log":
                put(torch.as_tensor(np.log(rng.uniform(1.0, 16.0, tuple(t.shape))),
                                    dtype=t.dtype))


def ssd_step_vs_plain(torch, ops, cfg, dev):
    """The C14 check (see SSD_CHECK_LAYERS)."""
    import dataclasses as dc

    from repro_torch.data import SynthSpec, batch_at
    from repro_torch.data.loader import to_device
    from repro_torch.kernels import ssd_chunk as sc
    from repro_torch.models import SINGLE, init_model
    from repro_torch.models.base import keystr, tree_flatten
    from repro_torch.train.optimizer import global_norm
    from repro_torch.train.trainstep import value_and_grad

    cut = dc.replace(cfg, n_layers=SSD_CHECK_LAYERS)
    model = init_model(cut, seed=TRAIN_SEED, device=dev, trainable=True)
    mamba2_decays(torch, model, TRAIN_SEED)
    batch = to_device(batch_at(SynthSpec(vocab=cut.vocab, seq_len=SSD_SEQ, batch=1, seed=0), 0),
                      dev)

    def run(backend):
        with ops.local_backend(backend):
            loss, _, grads = value_and_grad(model, cut, batch, SINGLE, remat=False)
        return float(loss), float(global_norm(grads)), grads

    counters = (sc.launches_bwd_state_wgmma, sc.launches_bwd_chunk_wgmma, sc.launches_bwd_sum)
    before = [k.value for k in counters]
    kl, kn, kg = run("cuda")
    check([k.value - v for k, v in zip(counters, before)] == [SSD_CHECK_LAYERS] * 3,
          "C14 check: the kernel route must launch each tensor-core backward kernel once a "
          "layer")
    pl, pn, pg = run("torch")
    zeros = [keystr(p) for p, g in tree_flatten(kg) if not bool((g != 0).any())]
    errs = leaf_errs(torch, kg, pg)
    ratios = {k: e / max(w, 1e-30) for k, (e, w) in errs.items()}
    worst = max(ratios.values())
    print(f"[train-ssd] C14 check, {SSD_CHECK_LAYERS} layers at full width, 1 x {SSD_SEQ} "
          f"tokens, Mamba-2's decays: loss {kl} vs plain {pl}, grad norm {kn} vs {pn}, worst "
          f"leaf |err| / max |g| {worst} (limit {SSD_GRAD_TOL}); leaves all zeros on the "
          f"kernel route: {zeros}; " + json.dumps(ratios), flush=True)
    check(not zeros, f"C14 check: gradient leaves all zeros on the kernel route: {zeros}")
    check(math.isfinite(kl) and abs(kl - pl) <= STEP_LOSS_TOL * abs(pl),
          f"C14 check: loss {kl} vs plain {pl}")
    check(math.isfinite(kn) and abs(kn - pn) <= STEP_GNORM_TOL * pn,
          f"C14 check: grad norm {kn} vs plain {pn}")
    check(worst <= SSD_GRAD_TOL, f"C14 check: gradients vs plain, worst {worst}")
    del kg

    class NoCarry(torch.autograd.Function):
        """The plain forward, and the plain backward that drops D_k g_k."""

        @staticmethod
        def forward(ctx, x, log_a, b, c, chunk):
            ctx.save_for_backward(x, log_a, b, c)
            ctx.chunk = chunk
            return plain(x, log_a, b, c, chunk)

        @staticmethod
        def backward(ctx, dy, dh):
            with carry_dropped(torch, sc):
                return (*sc.ssd_chunk_scan_bwd_plain(*ctx.saved_tensors, ctx.chunk, dy, dh),
                        None)

    plain = sc.ssd_chunk_scan_plain
    sc.ssd_chunk_scan_plain = NoCarry.apply
    try:
        _, _, cg = run("torch")
    finally:
        sc.ssd_chunk_scan_plain = plain
    cratios = {k: e / max(w, 1e-30) for k, (e, w) in leaf_errs(torch, cg, pg).items()}
    cworst = max(cratios.values())
    print(f"[train-ssd] control, the plain backward that drops the carry D_k g_k: worst leaf "
          f"|err| / max |g| {cworst} (limit {SSD_GRAD_TOL}): " + json.dumps(cratios),
          flush=True)
    check(cworst > SSD_GRAD_TOL, f"C14 control, the carry dropped: worst leaf {cworst} is "
          f"within the limit {SSD_GRAD_TOL}, which cannot see it")
    del model, pg, cg
    gc.collect()
    torch.cuda.empty_cache()


def ssd_counted_step(torch, ops, cfg, dev, steps_ms):
    """4j's count: the C14 check's 2-layer model, one step of 1 x 4,096
    tokens counted on the card by ``roofline.count()``, against the same
    step counted on meta by the dry run (flops equal, bytes within
    ROUTE_BYTES_TOL, as 4i holds smollm's), each SSD kernel launched as
    often as the counter charged it; then the full model's step counted on
    meta, and 4j's warm steps' shares of it (achieved TFLOP/s, mfu, the
    bound's share)."""
    import dataclasses as dc

    from repro_torch.configs import RunConfig
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import SynthSpec, batch_at
    from repro_torch.data.loader import to_device
    from repro_torch.launch import dryrun
    from repro_torch.launch import roofline as RL
    from repro_torch.models.base import SINGLE
    from repro_torch.train.trainstep import init_train_state, make_train_step

    shape = ShapeConfig("cli", "train", seq_len=SSD_SEQ, global_batch=1)
    cut = dc.replace(cfg, n_layers=SSD_CHECK_LAYERS)
    run = RunConfig(model=cut, shape=shape, dp=1, tp=1, remat="full")
    meta = dryrun.whole_step_counter(cut, run, SINGLE, "train")
    model, opt_state = init_train_state(cut, run, seed=TRAIN_SEED, device=dev)
    step_fn, _ = make_train_step(cut, run)
    batch = to_device(batch_at(SynthSpec(vocab=cut.vocab, seq_len=SSD_SEQ, batch=1, seed=0), 0),
                      dev)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    with RL.count() as c:
        step_fn(model, opt_state, batch)
        torch.cuda.synchronize()
    launches = ops.launch_counts()
    del model, opt_state
    gc.collect()
    torch.cuda.empty_cache()
    diffs = op_differences(c.by_op, meta.by_op)
    gap = abs(c.cost.bytes - meta.cost.bytes) / meta.cost.bytes
    want = {"ssd_chunk_scan": 2, "ssd_chunk_scan_inter": 2,
            **{k: 1 for k in SSD_BWD_WGMMA + SSD_BWD[2:]}, **{k: 0 for k in SSD_BWD[:2]}}
    print(f"[train-ssd] counted step, {SSD_CHECK_LAYERS} layers, 1 x {SSD_SEQ} tokens: on the "
          f"card {c.cost.flops} flops, {c.cost.bytes} bytes; on meta {meta.cost.flops}, "
          f"{meta.cost.bytes} ({gap} apart; ops that differ: {json.dumps(diffs)}); charged "
          + json.dumps(c.charged) + ", launched " + json.dumps({k: launches[k] for k in want}),
          flush=True)
    check(c.cost.flops == meta.cost.flops, f"4j: the step on the card counts {c.cost.flops} "
          f"flops, the meta dry run {meta.cost.flops}")
    check(gap < ROUTE_BYTES_TOL, f"4j: bytes on the card {c.cost.bytes} against "
          f"{meta.cost.bytes} on meta")
    for name, n in want.items():
        check(launches[name] == c.charged.get(name, 0) == n * SSD_CHECK_LAYERS,
              f"4j: {name} launched {launches[name]} times, charged {c.charged.get(name, 0)}, "
              f"a step of {SSD_CHECK_LAYERS} layers makes {n * SSD_CHECK_LAYERS}")
    full = dryrun.whole_step_counter(cfg, dc.replace(run, model=cfg), SINGLE, "train").cost
    return shares(f"{cfg.name} (4j)", full.flops, RL.model_flops_for(cfg, shape),
                  max(full.flops / RL.PEAK_FLOPS, full.bytes / RL.HBM_BW), steps_ms)


def training_ssd(torch, ops, dev):
    """Phase 4j: ``mamba2_2p7b`` at full width and depth trained through
    ``repro_torch.launch.train.main``; → the SSD kernels' launch counts
    over the launcher's run."""
    import re

    from repro_torch.configs import RunConfig, get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import SynthSpec, batch_at
    from repro_torch.data.loader import to_device
    from repro_torch.launch import train as launch_train
    from repro_torch.models.base import tree_flatten
    from repro_torch.train.trainstep import init_train_state, make_train_step

    cfg = get_config("mamba2_2p7b")
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[train-ssd] {cfg.name} at full width and depth: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_q_heads} heads x {cfg.ssd.head_dim}, N {cfg.ssd.d_state}, "
          f"chunk {cfg.ssd.chunk}, vocab {cfg.vocab}, {cfg.param_count()} parameters; launcher "
          f"flags {' '.join(SSD_FLAGS)}; predicted peak {SSD_PEAK_PREDICTED[0]}-"
          f"{SSD_PEAK_PREDICTED[1]} bytes; {torch.cuda.memory_allocated()} bytes held on the "
          "card before the run", flush=True)
    ops.reset_launch_counts()  # counts start at 0 just before the training path
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    whole, log = quiet(launch_train.main, SSD_FLAGS)
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    print(f"[train-ssd] {TRAIN_STEPS} steps in {wall} s: step ms "
          + json.dumps([t * 1e3 for t in whole.step_times]) + ", tokens/s "
          + json.dumps([SSD_SEQ / t for t in whole.step_times]) + ", losses "
          + json.dumps(whole.losses) + ", grad norms " + json.dumps(whole.grad_norms)
          + f", peak device memory {peak} bytes (predicted {SSD_PEAK_PREDICTED[0]}-"
          f"{SSD_PEAK_PREDICTED[1]}); launcher output: " + " | ".join(log.strip().splitlines()),
          flush=True)
    check(whole.steps == TRAIN_STEPS and all(math.isfinite(x) for x in
                                             whole.losses + whole.grad_norms),
          "Mamba-2 training: a loss or gradient norm is not finite")
    check(peak < 80e9, f"Mamba-2 training peak {peak} bytes, not under 80 GB")
    print("[train-ssd] launches in the run: " + json.dumps(
        {k: launches[k] for k in SSD_PER_STEP}), flush=True)
    for name, n in SSD_PER_STEP.items():
        check(launches[name] == n * TRAIN_STEPS, f"Mamba-2 training: {name} launched "
              f"{launches[name]} times in {TRAIN_STEPS} steps, not {n * TRAIN_STEPS}")
    gc.collect()
    torch.cuda.empty_cache()

    # the same step twice from the same state, bit for bit (the first state
    # waits on the host); the second step profiled
    shape = ShapeConfig("cli", "train", seq_len=SSD_SEQ, global_batch=1)
    run = RunConfig(model=cfg, shape=shape, dp=1, tp=1, remat="full")
    step_fn, _ = make_train_step(cfg, run)
    batch = to_device(batch_at(SynthSpec(vocab=cfg.vocab, seq_len=SSD_SEQ, batch=1,
                                         seed=TRAIN_SEED), 0), dev)
    kept = None
    for i in range(2):
        model, opt_state = init_train_state(cfg, run, seed=TRAIN_SEED, device=dev)
        if i == 0:
            model, opt_state, m0 = step_fn(model, opt_state, batch)
            kept = [t.detach().cpu() for _, t in tree_flatten({"params": model.tree(),
                                                               "opt": opt_state})]
        else:
            out = {}

            def one_step():
                out["state"] = step_fn(model, opt_state, batch)

            pwall, busy, copy, kern, _ = profiled(torch, one_step)
            model, opt_state, m1 = out.pop("state")
            leaves = [t for _, t in tree_flatten({"params": model.tree(), "opt": opt_state})]
            check(len(leaves) == len(kept) and all(
                torch.equal(a.detach().cpu(), b) for a, b in zip(leaves, kept)),
                "Mamba-2: the same step from the same state gave other params or optimizer "
                "state")
            check(float(m0["loss"]) == float(m1["loss"]), "Mamba-2: repeated step loss")
            del leaves
        del model, opt_state
    del kept
    gc.collect()
    torch.cuda.empty_cache()
    fwd = sum(t for t, k in kern if "ssd_" in k and "ssd_bwd" not in k)
    bwd = sum(t for t, k in kern if "ssd_bwd" in k)
    gemm = sum(t for t, k in kern if any(w in k.lower() for w in ("gemm", "nvjet", "xmma",
                                                                   "cutlass")))
    print(f"[train-ssd] a step repeated from the same state gave params, AdamW moments and "
          f"loss ({float(m1['loss'])}) equal bit for bit", flush=True)
    print(f"[train-ssd-trace] one step, profiled: wall {pwall} ms, device kernels {busy} ms "
          f"(SSD forward kernels {fwd} ms, SSD backward kernels {bwd} ms: "
          + ", ".join(f"{re.search(r'ssd_bwd_[a-z_]+', k).group(0)} {t}" for t, k in kern
                      if "ssd_bwd" in k)
          + f"; GEMMs {gemm} ms, elementwise and other {busy - fwd - bwd - gemm} ms), device "
          f"copies {copy} ms, device idle {100 * (1 - (busy + copy) / pwall)}%; top: "
          + ", ".join(f"{k[:50]} {t}" for t, k in kern[:10]), flush=True)

    ssd_step_vs_plain(torch, ops, cfg, dev)
    ssd_counted_step(torch, ops, cfg, dev, [t * 1e3 for t in whole.step_times[1:]])
    return {k: launches[k] for k in SSD_PER_STEP}


# --------------------------------------------------------------------------- #
# Phase 4i: the roofline on the card                                            #
# --------------------------------------------------------------------------- #
# (a) 4c's step (smollm_360m, 8 x 4,096 tokens, microbatch 4, remat full, one
# card) counted on meta tensors by the dry run, in parts and whole; (b) one
# real step of 4c's model on the card counted by ``roofline.count()``: its
# flops must equal (a)'s, its bytes too unless the card's route runs ops the
# meta route does not (each named, under 1% in all), and the attention
# launches the kernels made must equal the launches the counter charged, all
# on the tensor-core kernels; (c) the step's shares from 4c's warm steps, and
# 4h (b)'s qwen3_8b at 8 layers from its dry run and its untraced steps.
SMOLLM_PARAMS = 361_820_160  # the config's count, which model_flops_for reads
ROUTE_BYTES_TOL = 0.01


def op_differences(card, meta):
    """{op: (card calls, flops, bytes, meta calls, flops, bytes)} where the
    two counts differ."""
    out = {}
    for k in sorted(set(card) | set(meta)):
        a, b = card.get(k, [0, 0.0, 0.0]), meta.get(k, [0, 0.0, 0.0])
        if list(a) != list(b):
            out[k] = list(a) + list(b)
    return out


def shares(name, flops, model_flops, bound_s, steps_ms):
    """Achieved TFLOP/s, mfu and the roofline bound's share of each step."""
    from repro_torch.launch.roofline import PEAK_FLOPS

    rows = [{"step_ms": ms, "tflops": flops / (ms / 1e3) / 1e12,
             "mfu": model_flops / (ms / 1e3 * PEAK_FLOPS), "bound_share": bound_s / (ms / 1e3)}
            for ms in steps_ms]
    print(f"[roofline] {name}: counted flops {flops}, model flops {model_flops}, bound "
          f"{bound_s * 1e3} ms; per warm step " + json.dumps(rows), flush=True)
    return rows


def roofline_phase(torch, ops, dev):
    """Phase 4i; → the JSON object printed before the last lines."""
    from repro_torch.configs import RunConfig, get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import SynthSpec, batch_at
    from repro_torch.data.loader import to_device
    from repro_torch.launch import dryrun
    from repro_torch.launch import roofline as RL
    from repro_torch.models.base import SINGLE, ShardCtx
    from repro_torch.train.trainstep import init_train_state, make_train_step

    t_phase = time.perf_counter()
    cfg = get_config("smollm_360m")
    shape = ShapeConfig("train_4k", "train", 4096, TRAIN_BATCH)
    run = RunConfig(model=cfg, shape=shape, dp=1, tp=1, remat="full", microbatch=TRAIN_MICRO)

    # (a) the dry run of 4c's step on meta: in parts (the dry run's row) and whole
    t0 = time.perf_counter()
    row = dryrun.dryrun_cell(cfg.name, shape.name, cfg=cfg, shape=shape, ctx=SINGLE,
                             microbatch=TRAIN_MICRO, verbose=False)
    split_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    meta = dryrun.whole_step_counter(cfg, run, SINGLE, "train")
    whole = meta.cost
    whole_s = time.perf_counter() - t0
    want = 6 * SMOLLM_PARAMS * shape.global_batch * shape.seq_len
    check(row["model_flops"] == want == RL.model_flops_for(cfg, shape),
          f"4i (a): model flops {row['model_flops']}, not 6 x {SMOLLM_PARAMS} x "
          f"{shape.global_batch * shape.seq_len} = {want}")
    check(row["hlo_flops_per_dev"] == whole.flops and row["bytes_per_dev"] == whole.bytes,
          f"4i (a): the dry run in parts ({row['hlo_flops_per_dev']} flops, "
          f"{row['bytes_per_dev']} bytes) is not the whole step counted on meta ({whole.flops}, "
          f"{whole.bytes})")
    print(f"[roofline] (a) {cfg.name}, {shape.global_batch} x {shape.seq_len} tokens, microbatch "
          f"{TRAIN_MICRO}, remat full, on meta: flops {whole.flops}, bytes {whole.bytes}, "
          f"model flops {row['model_flops']}; t_compute {row['t_compute_s']} s, t_memory "
          f"{row['t_memory_s']} s, t_collective {row['t_collective_s']} s ({row['bottleneck']}); "
          f"the parts {json.dumps(row['detail'])} equal the whole step; counted in {split_s} s "
          f"(parts) and {whole_s} s (whole)", flush=True)

    # (b) one real step of 4c's model on the card, counted
    model, opt_state = init_train_state(cfg, run, seed=TRAIN_SEED, device=dev)
    step_fn, _ = make_train_step(cfg, run)
    batch = to_device(batch_at(SynthSpec(vocab=cfg.vocab, seq_len=shape.seq_len,
                                         batch=TRAIN_BATCH, seed=0), 0), dev)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with RL.count() as c:
        model, opt_state, metrics = step_fn(model, opt_state, batch)
        torch.cuda.synchronize()
    counted_ms = (time.perf_counter() - t0) * 1e3
    launches = ops.launch_counts()
    loss = float(metrics["loss"])
    del model, opt_state, metrics
    gc.collect()
    torch.cuda.empty_cache()
    card = c.cost
    diffs = op_differences(c.by_op, meta.by_op)
    check(math.isfinite(loss), "4i (b): the counted step's loss is not finite")
    check(card.flops == whole.flops, f"4i (b): the step on the card counts {card.flops} flops, "
          f"the meta dry run {whole.flops}; ops that differ: " + json.dumps(diffs))
    gap = abs(card.bytes - whole.bytes) / whole.bytes
    check(gap < ROUTE_BYTES_TOL, f"4i (b): bytes on the card {card.bytes} against {whole.bytes} "
          f"on meta, {gap} apart; ops that differ: " + json.dumps(diffs))
    for name in ("flash_attention", "flash_attention_bwd_dq", "flash_attention_bwd_dkdv"):
        n = c.charged.get(name, 0)
        check(launches[name] == n == PER_STEP[name] and launches[name + "_wgmma"] == n,
              f"4i (b): {name} launched {launches[name]} times ({launches[name + '_wgmma']} on "
              f"the tensor cores), the counter charged {n}, a step makes {PER_STEP[name]}")
    print(f"[roofline] (b) one step of {cfg.name} on the card, counted ({counted_ms} ms with the "
          f"counter): flops {card.flops} (equal to the meta dry run's), bytes {card.bytes} against "
          f"{whole.bytes} ({gap} apart; ops that differ: {json.dumps(diffs)}); attention charged "
          + json.dumps(c.charged) + ", launched " + json.dumps(
              {k: launches[k] for k in PER_STEP}) + f"; loss {loss}", flush=True)

    # (c) the shares of 4c's warm steps, and of 4h (b)'s qwen3_8b at 8 layers
    smol = shares(f"{cfg.name} (4c)", whole.flops, row["model_flops"],
                  max(whole.flops / RL.PEAK_FLOPS, whole.bytes / RL.HBM_BW), STEP_MS["4c"][1:])
    qcfg = dataclasses.replace(get_config("qwen3_8b"), n_layers=FSDP_QWEN_LAYERS)
    qshape = ShapeConfig("train_4k", "train", 4096, FSDP_QWEN_BATCH)
    t0 = time.perf_counter()
    qrow = dryrun.dryrun_cell(qcfg.name, qshape.name, cfg=qcfg, shape=qshape,
                              ctx=ShardCtx(dp=FSDP_DP), verbose=False)
    q_s = time.perf_counter() - t0
    qflops = qrow["hlo_flops_per_dev"] * qrow["chips"]  # the four rows share one card
    qbytes = qrow["bytes_per_dev"] * qrow["chips"]
    print(f"[roofline] (a) {qcfg.name} at {FSDP_QWEN_LAYERS} layers, {FSDP_QWEN_BATCH} x 4,096 "
          f"tokens over {FSDP_DP} data rows, on meta in {q_s} s: flops {qflops}, bytes {qbytes}, "
          f"model flops {qrow['model_flops']}; collectives reckoned for {FSDP_DP} cards "
          + json.dumps(qrow["collectives"]) + f" (t_collective {qrow['t_collective_s']} s a card; "
          "on one card the rows' gathers are copies within it)", flush=True)
    warm = STEP_MS["4h"][1:]
    qwen = shares(f"{qcfg.name} at {FSDP_QWEN_LAYERS} layers (4h b)", qflops, qrow["model_flops"],
                  max(qflops / RL.PEAK_FLOPS, qbytes / RL.HBM_BW), warm)
    took = time.perf_counter() - t_phase
    print(f"[roofline] phase took {took} s", flush=True)
    return {"smollm_360m": {"flops": whole.flops, "bytes": whole.bytes,
                            "card_bytes": card.bytes, "model_flops": row["model_flops"],
                            "charged": c.charged, "steps": smol},
            "qwen3_8b_8_layers": {"flops": qflops, "bytes": qbytes,
                                  "model_flops": qrow["model_flops"], "steps": qwen},
            "phase_s": took}


# --------------------------------------------------------------------------- #
# phase 4k: the five registered models no earlier phase runs                    #
# --------------------------------------------------------------------------- #

# Each is made from a seed with random weights at full width, served behind
# an OpportunisticServer, decoded at 2 layers against a cache-free forward,
# then trained 4 steps of one 4,096-token sequence (the reference's
# train_4k length, its global batch 256 cut to one card; a VLM's 256 patch
# embeddings before them), remat full, float32 master weights and AdamW.
REGISTRY = ("musicgen_large", "h2o_danube_3_4b", "starcoder2_7b", "qwen3_moe_30b_a3b",
            "internvl2_76b")
REG_SEQ = 4096
# Depth is cut only where the reckoned bytes pass REG_BUDGET (of the card's
# 80 GB): serving at 2 bytes a parameter (bf16) plus SERVE_SLACK for a
# 1,024-token prefill's activations and logits and the prefix caches the
# server keeps; training at TRAIN_STATE_BYTES a parameter (float32 weights,
# gradients and both moments) plus train_extra (the step's logits, the
# layer inputs remat keeps, one stacked leaf's float32 gradient beside its
# accumulator, and TRAIN_SLACK: one layer's recomputed activations, the
# bf16 casts and the allocator).  4j's mamba2_2p7b peaked 7.9 GB over its
# state and 4e's RecurrentGemma group 13.3 GB (its 256,000-token head).
REG_BUDGET = 76e9
SERVE_SLACK = 4e9
TRAIN_STATE_BYTES = 16
TRAIN_SLACK = 4e9
REG_CHECK_LAYERS = 2  # decode and kernels-vs-plain checks: the first 2 layers at full width
# 4k serves and trains each model at most this deep (the reckoned depth where
# it is shallower), so that the whole script keeps to its time: with the
# reckoned depths (serve 48, 24, 32, 48, 39; train 48, 24, 16, 5, 2) it took
# 1,090.2 s of command time on an H100 80GB HBM3 at 700 W
REG_MAX_LAYERS = 24


def reg_cut(cfg):
    """``cfg`` at most REG_MAX_LAYERS deep: the config phase 4k reckons."""
    return dataclasses.replace(cfg, n_layers=min(cfg.n_layers, REG_MAX_LAYERS))


def layer_params(cfg):
    """(parameters a layer, parameters outside the layers) of a config whose
    blocks are all attention, reckoned from its widths as the specs of
    ``models/{layers,attention,moe}.py`` lay them out."""
    d, hd = cfg.d_model, cfg.head_dim
    vocab = -(-cfg.vocab // 8) * 8  # padded_vocab(1)
    norm = 2 * d if cfg.norm_type == "layernorm" else d
    q, kv = cfg.n_q_heads * hd, cfg.n_kv_heads * hd
    attn = 2 * d * q + 2 * d * kv + (2 * hd if cfg.qk_norm else 0)
    mats = 3 if cfg.mlp_type in ("swiglu", "geglu") else 2
    if cfg.moe is not None:
        E = cfg.moe.n_experts
        ffn = d * E + mats * E * d * cfg.moe.d_ff_expert
    else:
        ffn = mats * d * cfg.d_ff
    heads = 1 if cfg.tie_embeddings else 2
    return attn + 2 * norm + ffn, heads * cfg.n_codebooks * vocab * d + norm


def train_extra(cfg, layers):
    """The bytes a training step holds beside its state (see REG_BUDGET)."""
    d = cfg.d_model
    vocab = -(-cfg.vocab // 8) * 8
    tokens = REG_SEQ + cfg.n_vis_tokens
    logits = 8 * REG_SEQ * cfg.n_codebooks * vocab  # float32 logits and their gradient
    bounds = 2 * layers * tokens * d  # each layer's bf16 input, kept by remat
    if cfg.moe is not None:
        leaf = cfg.moe.n_experts * d * cfg.moe.d_ff_expert
    else:
        leaf = max(d * cfg.n_q_heads * cfg.head_dim, d * cfg.d_ff)
    return logits + bounds + 4 * layers * leaf + TRAIN_SLACK


def reckon_depth(cfg, kind):
    """The depth phase 4k runs ``cfg`` at (``kind`` "serve" or "train"): the
    config's own, or the deepest whose reckoned bytes stay within REG_BUDGET
    → {layers, params, bytes, and the whole model's}."""
    per, outer = layer_params(cfg)

    def need(layers):
        n = outer + layers * per
        if kind == "serve":
            return n, 2 * n + SERVE_SLACK
        return n, TRAIN_STATE_BYTES * n + train_extra(cfg, layers)

    layers = cfg.n_layers
    while layers > 1 and need(layers)[1] > REG_BUDGET:
        layers -= 1
    n, b = need(layers)
    check(b <= REG_BUDGET, f"{cfg.name}: one layer takes {b} bytes to {kind}, over {REG_BUDGET}")
    whole_n, whole_b = need(cfg.n_layers)
    return {"layers": layers, "of": cfg.n_layers, "params": n, "bytes": b,
            "whole_params": whole_n, "whole_bytes": whole_b, "per_layer": per, "outer": outer}


def reckoning_line(cfg, kind, r):
    how = ("bf16 weights at 2 bytes a parameter + " + f"{SERVE_SLACK:.0f}" if kind == "serve"
           else f"state at {TRAIN_STATE_BYTES} bytes a parameter + the step's "
           f"{train_extra(cfg, r['layers']):.0f}")
    cut = "the whole" if r["layers"] == r["of"] else (
        f"cut: the whole ({r['whole_params']} parameters) needs {r['whole_bytes']:.0f}")
    return (f"{kind} at {r['layers']} of {r['of']} layers: {r['params']} parameters ({r['per_layer']} "
            f"a layer + {r['outer']}), {r['bytes']:.0f} bytes reckoned ({how}; limit "
            f"{REG_BUDGET:.0f}); {cut}")


def reg_launches(layers):
    """The attention launches of one 4k step at ``layers`` layers: the
    forward twice a layer (remat), each backward kernel once, all on the
    tensor cores."""
    return {"flash_attention": 2 * layers, "flash_attention_wgmma": 2 * layers,
            "flash_attention_bwd_dq": layers, "flash_attention_bwd_dkdv": layers,
            "flash_attention_bwd_dq_wgmma": layers, "flash_attention_bwd_dkdv_wgmma": layers}


def reg_batch(torch, cfg, step, dev):
    """Step ``step``'s batch: 1 x REG_SEQ tokens (of each codebook) from the
    synthetic stream (seed TRAIN_SEED, as the launcher's ``--seed``), and a
    VLM's patch embeddings."""
    from repro_torch.data import SynthSpec, batch_at
    from repro_torch.data.loader import to_device

    batch = to_device(batch_at(SynthSpec(vocab=cfg.vocab, seq_len=REG_SEQ, batch=1,
                                         n_codebooks=cfg.n_codebooks, seed=TRAIN_SEED), step),
                      dev)
    if cfg.n_vis_tokens:
        batch["vis_embeds"] = vis_embeds(torch, cfg, 1, dev, seed=TRAIN_SEED + step)
    return batch


def registry_serving(torch, ops, cfg, dev):
    """4k's serving: ``cfg`` at its reckoned serving depth behind an
    OpportunisticServer (``serve_model``), its first 2 layers decoded
    against a cache-free forward, an MoE's layer 0 against float64."""
    import dataclasses as dc

    from repro_torch.models import init_model

    r = reckon_depth(reg_cut(cfg), "serve")
    cut = cfg if r["layers"] == cfg.n_layers else dc.replace(cfg, n_layers=r["layers"])
    t0 = time.perf_counter()
    model = init_model(cut, seed=SERVE_SEED, device=dev)
    torch.cuda.synchronize()
    params = list(model.parameters())
    n = sum(p.numel() for p in params)
    nbytes = sum(p.numel() * p.element_size() for p in params)
    del params
    check(n == r["params"], f"{cfg.name}: the served model has {n} parameters, the reckoning "
          f"{r['params']}")
    print(f"[reg-serve] {cfg.name}: {cut.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_q_heads}/{cfg.n_kv_heads} heads x {cfg.head_dim}, vocab {cfg.vocab}"
          + (f" x {cfg.n_codebooks} codebooks" if cfg.n_codebooks > 1 else "")
          + f": {n} parameters, {nbytes} bytes on the card, made in {time.perf_counter() - t0} s",
          flush=True)

    def checks(cold_t):
        decode_vs_forward(torch, ops, dc.replace(cfg, n_layers=REG_CHECK_LAYERS), model, dev,
                          DECODE_STEPS, "reg-serve")
        if cfg.moe is not None:
            moe_layer0(torch, cut, model, cold_t, dev)

    launches = serve_model(torch, ops, cut, model, dev, "reg-serve", checks, trace_decode=False)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def registry_training(torch, ops, name, dev):
    """4k's training: ``name``'s config at its reckoned training depth, 4 steps of
    1 x REG_SEQ tokens (through ``launch.train.main`` where the whole model
    fits, else ``make_train_step`` on the cut config), the attention
    launches a step as predicted; the first step again from the same state
    under ``roofline.count()`` (its flops equal to the meta dry run's, its
    bytes within ROUTE_BYTES_TOL, the attention launches the counter
    charged), then once more profiled: params, moments and loss equal;
    check 2 at REG_CHECK_LAYERS layers.  → the training run's launches."""
    import dataclasses as dc

    from repro_torch.configs import RunConfig, get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch import roofline as RL
    from repro_torch.launch import train as launch_train
    from repro_torch.models import SINGLE, init_model
    from repro_torch.train.trainstep import init_train_state, make_train_step

    cfg = get_config(name)
    r = reckon_depth(reg_cut(cfg), "train")
    layers = r["layers"]
    cut = cfg if layers == cfg.n_layers else dc.replace(cfg, n_layers=layers)
    shape = ShapeConfig("cli", "train", seq_len=REG_SEQ, global_batch=1)
    run = RunConfig(model=cut, shape=shape, dp=1, tp=1, remat="full")
    opt = launcher_opt(TRAIN_STEPS)
    want = reg_launches(layers)
    tokens = REG_SEQ + cut.n_vis_tokens
    gc.collect()
    torch.cuda.empty_cache()
    ops.reset_launch_counts()  # counts start at 0 just before the training path
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    if layers == cfg.n_layers:
        flags = ["--arch", name, "--full-config", "--steps",
                 str(TRAIN_STEPS), "--batch", "1", "--seq", str(REG_SEQ), "--remat", "full",
                 "--seed", str(TRAIN_SEED)]
        stats, log = quiet(launch_train.main, flags)
        steps_ms = [t * 1e3 for t in stats.step_times]
        losses, norms = stats.losses, stats.grad_norms
        how = "launch.train.main " + " ".join(flags) + "; launcher output: " + " | ".join(
            log.strip().splitlines())
    else:
        model, opt_state = init_train_state(cut, run, seed=TRAIN_SEED, device=dev)
        step_fn, _ = make_train_step(cut, run, opt=opt)
        steps_ms, losses, norms = [], [], []
        for step in range(TRAIN_STEPS):
            batch = reg_batch(torch, cut, step, dev)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            model, opt_state, m = step_fn(model, opt_state, batch)
            losses.append(float(m["loss"]))
            steps_ms.append((time.perf_counter() - t1) * 1e3)
            norms.append(float(m["grad_norm"]))
        del model, opt_state, m, batch
        how = f"make_train_step on the config cut to {layers} layers"
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    print(f"[reg-train] {cfg.name}, {TRAIN_STEPS} steps of 1 x {tokens} tokens ({how}) in {wall} "
          "s: step ms " + json.dumps(steps_ms) + ", tokens/s "
          + json.dumps([tokens / t * 1e3 for t in steps_ms]) + ", losses " + json.dumps(losses)
          + ", grad norms " + json.dumps(norms) + f", peak device memory {peak} bytes (reckoned "
          f"{r['bytes']:.0f}); launches " + json.dumps({k: launches[k] for k in want}),
          flush=True)
    check(len(losses) == TRAIN_STEPS and all(math.isfinite(x) for x in losses + norms),
          f"{cfg.name} training: a loss or gradient norm is not finite")
    for name, n in want.items():
        check(launches[name] == n * TRAIN_STEPS, f"{cfg.name} training: {name} launched "
              f"{launches[name]} times in {TRAIN_STEPS} steps, not {n * TRAIN_STEPS}")
    gc.collect()
    torch.cuda.empty_cache()

    # the first step twice from the same state: counted, then profiled
    t0 = time.perf_counter()
    meta = dryrun.whole_step_counter(cut, run, SINGLE, "train")
    meta_s = time.perf_counter() - t0
    step_fn, _ = make_train_step(cut, run, opt=opt)
    batch = reg_batch(torch, cut, 0, dev)
    prints, step_loss = [], []
    for i in range(2):
        model, opt_state = init_train_state(cut, run, seed=TRAIN_SEED, device=dev)
        torch.cuda.synchronize()
        if i == 0:
            ops.reset_launch_counts()
            with RL.count() as c:
                model, opt_state, m = step_fn(model, opt_state, batch)
                torch.cuda.synchronize()
            counted = ops.launch_counts()
        else:
            out = {}

            def one_step():
                out["state"] = step_fn(model, opt_state, batch)

            with moe_ranges(torch, cfg.moe is not None) as ranges:
                pwall, busy, copy, kern, spans = profiled(torch, one_step, ranges)
            model, opt_state, m = out.pop("state")
        step_loss.append(m["loss"])
        prints.append(fingerprint(torch, {"params": model.tree(), "opt": opt_state}))
        del model, opt_state, m
        gc.collect()
        torch.cuda.empty_cache()
    repeat_s = time.perf_counter() - t0 - meta_s
    check(prints[0] == prints[1] and torch.equal(step_loss[0], step_loss[1]),
          f"{cfg.name}: the same step from the same state gave other params, moments or loss: "
          + json.dumps([k for k in prints[0] if prints[0][k] != prints[1][k]]))
    diffs = op_differences(c.by_op, meta.by_op)
    gap = abs(c.cost.bytes - meta.cost.bytes) / meta.cost.bytes
    print(f"[reg-train] {cfg.name}: the step repeated from the same state gave params, AdamW "
          f"moments (all {len(prints[0])} leaves' two 64-bit checksums) and loss "
          f"({float(step_loss[0])}) equal; counted on the card {c.cost.flops} flops, "
          f"{c.cost.bytes} bytes, on meta {meta.cost.flops}, {meta.cost.bytes} ({gap} apart; ops "
          f"that differ: {json.dumps(diffs)}); charged " + json.dumps(c.charged) + ", launched "
          + json.dumps({k: counted[k] for k in want}) + f"; counted on meta in {meta_s} s, the "
          f"two steps with their states made and fingerprinted in {repeat_s} s", flush=True)
    check(c.cost.flops == meta.cost.flops, f"4k {cfg.name}: the step on the card counts "
          f"{c.cost.flops} flops, the meta dry run {meta.cost.flops}; ops that differ: "
          + json.dumps(diffs))
    check(gap < ROUTE_BYTES_TOL, f"4k {cfg.name}: bytes on the card {c.cost.bytes} against "
          f"{meta.cost.bytes} on meta; ops that differ: " + json.dumps(diffs))
    for name in ("flash_attention", "flash_attention_bwd_dq", "flash_attention_bwd_dkdv"):
        n = c.charged.get(name, 0)
        check(counted[name] == counted[name + "_wgmma"] == n == want[name],
              f"4k {cfg.name}: {name} launched {counted[name]} times ({counted[name + '_wgmma']} "
              f"on the tensor cores), the counter charged {n}, a step makes {want[name]}")
    attn, gemm, moved = trace_split(kern, cfg.moe is not None)
    moe_part = (f", MoE sort / gather / scatter / index {moved} ms; the MoE layer's forward and "
                "remat passes (host ms, device ms) " + json.dumps(spans)
                if cfg.moe is not None else "")
    print(f"[reg-trace] {cfg.name} one step at {layers} layers, profiled: wall {pwall} ms, device "
          f"kernels {busy} ms (attention kernels {attn} ms, GEMMs {gemm} ms{moe_part}, other "
          f"{busy - attn - gemm - moved} ms), device copies {copy} ms, device idle "
          f"{100 * (1 - (busy + copy) / pwall)}%; top: "
          + ", ".join(f"{k[:50]} {t}" for t, k in kern[:8]), flush=True)
    shares(f"{cfg.name} at {layers} layers (4k)", meta.cost.flops, RL.model_flops_for(cut, shape),
           max(meta.cost.flops / RL.PEAK_FLOPS, meta.cost.bytes / RL.HBM_BW), steps_ms[1:])

    # check 2: the kernels against the plain attention, the first 2 layers
    t0 = time.perf_counter()
    small = dc.replace(cfg, n_layers=REG_CHECK_LAYERS)
    model = init_model(small, seed=TRAIN_SEED, device=dev, trainable=True)
    (moe_step_vs_plain if cfg.moe is not None else step_vs_plain)(torch, ops, small, model, dev)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[reg-train] {cfg.name}: check 2 took {time.perf_counter() - t0} s", flush=True)
    return {k: launches[k] for k in TRAINING}


def registry_phase(torch, ops, dev):
    """Phase 4k: each of REGISTRY served and trained (depths reckoned and
    printed first); → the attention launches of its training runs."""
    from repro_torch.configs import get_config

    t_phase = time.perf_counter()
    for name in REGISTRY:
        cfg = get_config(name)
        for kind in ("serve", "train"):
            print(f"[reg] {cfg.name} " + reckoning_line(cfg, kind, reckon_depth(cfg, kind))
                  + f"; run at most {REG_MAX_LAYERS} deep", flush=True)
    total = {k: 0 for k in TRAINING}
    for name in REGISTRY:
        cfg = get_config(name)
        t0 = time.perf_counter()
        registry_serving(torch, ops, cfg, dev)
        serve_s = time.perf_counter() - t0
        for k, n in registry_training(torch, ops, name, dev).items():
            total[k] += n
        print(f"[reg] {cfg.name} took {time.perf_counter() - t0} s (serving {serve_s} s)",
              flush=True)
    print("[reg] flash_attention launches in phase 4k: " + json.dumps(total)
          + f"; phase took {time.perf_counter() - t_phase} s", flush=True)
    return total


# ---------------------------------------------------------------- phase 4l --

TP_SHARDS = 4
TP_MODELS = ("internvl2_76b", "starcoder2_7b")
# Depth is cut only where the whole model (the no-mesh reference) and its
# four slices, each reckoned from the placements (tp_reckoning: every leaf
# in its serving type), pass TP_BUDGET together with TP_SLACK: the two
# cache-free forwards' bf16 logits over 4,096 positions, the activations at
# 4,352 positions, layer 0's weights cast to float64 one at a time, and the
# serving caches.
TP_BUDGET = REG_BUDGET
TP_SLACK = 10e9
TP_PROMPT = 1024
TP_TOL = DECODE_TOL  # of the largest |value|: logits, layer 0's output, decode steps
TP_CAPACITY = 2048  # the serving caches' slots
# The logits and the decode steps are held on the models cut to their first
# TP_HOLD_DEPTH layers (as phase 4k holds its decode check): through 16
# random-weight layers of internvl2_76b the whole and the sliced paths'
# roundings grew 0.52 of a largest |logit| of 11.8 apart (an H100), as one
# bf16 rounding grows through phase 4b's 64 layers.  The distances are
# printed at TP_DEPTHS and the full depth.
TP_HOLD_DEPTH = 2
TP_DEPTHS = (1, 2, 4, 8)
TP_RANGES = ("tp_broadcast", "tp_sum", "tp_gather", "tp_seq_gather", "tp_seq_scatter")
# the cache-free forward under sequence parallelism sums only into its slices
TP_SP_FORWARD_RANGES = tuple(r for r in TP_RANGES if r != "tp_sum")
# layer 0 against float64 on its first positions (causal: they see only
# each other), so that the float64 products stay small
TP_F64_POSITIONS = 1024
# the forward kernel at the shards' shapes (phase 4l): internvl2_76b's 64
# (8) heads and starcoder2_7b's 36 (4), each a quarter a shard
TP_ATTN = {
    "internvl2_76b tp4": (1, 16, 2, 4352, 4352, 128, "bfloat16", True, None, 0),
    "starcoder2_7b tp4": (1, 9, 1, 4096, 4096, 128, "bfloat16", True, None, 0),
}


def tp_reckoning(cfg, ctx):
    """The bytes each of ``ctx.tp`` model shards of a data row holds of
    ``cfg``'s serving weights, reckoned from the placements
    (``tp.model_dim``): a split leaf a ``tp``-th on every shard, a whole one
    on shard 0."""
    from repro_torch.models import tp as TP
    from repro_torch.models.base import tree_flatten
    from repro_torch.models.layers import compute_dtype
    from repro_torch.models.lm import model_spec

    compute = compute_dtype(cfg)
    out = [0] * ctx.tp
    for path, s in tree_flatten(model_spec(cfg, ctx)):
        nbytes = math.prod(s.shape) * s.dtype(compute).itemsize
        if TP.model_dim(s.placement, path) is None:
            out[0] += nbytes
        else:
            out = [b + nbytes // ctx.tp for b in out]
    return out


def tp_depth(cfg):
    """Phase 4l's depth for ``cfg``: its own, or the deepest at which the
    whole model and its slices (twice the placements' bytes) and TP_SLACK
    fit TP_BUDGET → {layers, of, bytes}."""
    from repro_torch.models import ShardCtx

    ctx = ShardCtx(tp=TP_SHARDS)

    def need(layers):
        return 2 * sum(tp_reckoning(dataclasses.replace(cfg, n_layers=layers), ctx)) + TP_SLACK

    layers = cfg.n_layers
    while layers > 1 and need(layers) > TP_BUDGET:
        layers -= 1
    b = need(layers)
    check(b <= TP_BUDGET, f"{cfg.name}: one layer and its slices take {b} bytes, over "
          f"{TP_BUDGET}")
    return {"layers": layers, "of": cfg.n_layers, "bytes": b}


def tp_train_reckoning(cfg, dp, tp, arrays=TRAIN_STATE_BYTES // 4):
    """The bytes each card of a ``(dp, tp)`` mesh holds of ``cfg``'s float32
    train state under TP × FSDP, row-major over (row, shard), reckoned from
    the placements at ``ShardCtx(tp, dp)``: ``arrays`` float32 copies of a
    leaf (weights, both moments and, at 4, the gradient's accumulators),
    ``1/dp`` of it where the placement names the data axis, ``1/tp`` on
    every shard where it names the model axis (``tp.model_dim``), else on
    the row's first card."""
    from repro_torch.models import ShardCtx
    from repro_torch.models import tp as TP
    from repro_torch.models.base import tree_flatten
    from repro_torch.models.lm import model_spec

    ctx = ShardCtx(tp=tp, dp=dp)
    out = [0] * (dp * tp)
    for path, s in tree_flatten(model_spec(cfg, ctx)):
        n = math.prod(s.shape)
        if dp > 1 and ctx.data_spec() in s.placement:
            n //= dp
        split = TP.model_dim(s.placement, path) is not None
        for r in range(dp):
            for shard in range(tp if split else 1):
                out[r * tp + shard] += 4 * arrays * (n // tp if split else n)
    return out


def tp_train_extra(cfg, layers, dp, tp, batch, seq=REG_SEQ):
    """The bytes a TP × FSDP step holds on a row's first card beside its
    state: its vocabulary slice of the row's float32 logits and their
    gradient (the loss is taken on the slices), its sequence slice of the
    bf16 layer inputs remat keeps (the residual stream between blocks in
    sequence slices), one layer's shard slices gathered in float32 and
    their gradient, the global norm's largest gather (a stacked leaf past
    ``NORM_WHOLE_MAX`` a layer at a time) and TRAIN_SLACK.  Without
    sequence parallelism (``lm.seq_parallel``: a sequence tp does not
    divide) the layer inputs lie whole on the first card.  An MoE takes the
    whole batch on the first row (``lm.data_rows``: routed at one capacity,
    as the reference's ``moe_ffn``), so its first row's cards hold the
    whole batch's logits and layer inputs."""
    from repro_torch.models import ShardCtx
    from repro_torch.models.base import tree_flatten
    from repro_torch.models.lm import model_spec
    from repro_torch.train.optimizer import NORM_WHOLE_MAX

    cut = dataclasses.replace(cfg, n_layers=layers)
    per, _ = layer_params(cut)
    from repro_torch.models.lm import seq_parallel

    tokens = batch // (1 if cut.moe is not None else dp) * (seq + cut.n_vis_tokens)
    logits = 8 * tokens * cut.n_codebooks * cut.padded_vocab(tp) // tp
    bounds = 2 * layers * tokens * cut.d_model
    if seq_parallel(True, seq + cut.n_vis_tokens, tp, None):
        bounds //= tp
    norm = 0
    for _, s in tree_flatten(model_spec(cut, ShardCtx(tp=tp, dp=dp))):
        n = math.prod(s.shape)
        norm = max(norm, n if n <= NORM_WHOLE_MAX else n // s.shape[0])
    return logits + bounds + 2 * 4 * per // tp + 4 * norm + TRAIN_SLACK


def tp_train_depth(cfg, dp, tp, batch):
    """The deepest cut of ``cfg`` whose fullest card (its state,
    :func:`tp_train_reckoning`, and a row's first card's step bytes,
    :func:`tp_train_extra`) stays within REG_BUDGET over a ``(dp, tp)`` mesh
    → {layers, of, cards (each card's state bytes), bytes (the fullest
    card's with the step's)}."""
    def need(layers):
        cut = dataclasses.replace(cfg, n_layers=layers)
        cards = tp_train_reckoning(cut, dp, tp)
        return cards, max(cards) + tp_train_extra(cfg, layers, dp, tp, batch)

    layers = cfg.n_layers
    while layers > 1 and need(layers)[1] > REG_BUDGET:
        layers -= 1
    cards, b = need(layers)
    check(b <= REG_BUDGET, f"{cfg.name}: one layer takes {b} bytes a card over ({dp}, {tp}), "
          f"over {REG_BUDGET}")
    return {"layers": layers, "of": cfg.n_layers, "cards": cards, "bytes": b}


def cache_cards(torch, cfg, cache, mesh, batch, capacity, label):
    """A served cache tree over ``mesh``'s first row where the reference
    places it: each shard's bytes (``lm.cache_shard_bytes``: slice s of a
    field held in slices on shard s, a whole tensor on shard 0) against the
    reckoning from ``make_cache_specs`` (``launch.specs.cache_shard_bytes``,
    with its one exception: a window ring whose kv heads do not divide tp
    stays whole), every slice on its shard's device and every whole tensor
    on the row's first → each shard's bytes."""
    from repro_torch.launch import specs
    from repro_torch.launch.mesh import indexed_device
    from repro_torch.models import lm
    from repro_torch.models.base import tree_leaves

    tp = mesh.tp
    got = lm.cache_shard_bytes(cache, tp)
    want = specs.cache_shard_bytes(cfg, tp, batch, capacity)
    check(got == want, f"{cfg.name} {label}: the shards hold {got} bytes of the caches, the "
          f"placements reckon {want}")
    homes = [indexed_device(mesh.device(0, s)) for s in range(tp)]
    for c in tree_leaves(cache):
        for f in dataclasses.fields(c):
            v = getattr(c, f.name)
            if isinstance(v, tuple):
                check([indexed_device(t.device) for t in v] == homes,
                      f"{cfg.name} {label}: a {type(c).__name__}.{f.name} slice off its shard")
            elif torch.is_tensor(v):
                check(indexed_device(v.device) == homes[0],
                      f"{cfg.name} {label}: a whole {type(c).__name__}.{f.name} off the first "
                      "device")
    return got


def checked_prefill(torch, cfg, pre, mesh, capacity, seen):
    """``pre`` (a serve fn's prefill over ``mesh``) that also holds the
    cache it makes where the reference places it (:func:`cache_cards`),
    each shard's bytes appended to ``seen``."""
    def prefill(model, prompt):
        logits, cache = pre(model, prompt)
        seen.append(cache_cards(torch, cfg, cache, mesh, prompt.shape[0], capacity,
                                "after the prefill"))
        return logits, cache

    return prefill


def decode_moves(torch, fn):
    """One decode step ``fn()`` traced → (the ``tp_gather`` ranges it ran:
    each ``tp.join``, the head's logits among them; the ``tp.scatter``
    calls, whose range is ``tp_broadcast``, counted on the function)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import tp as TP

    scatter, calls = TP.scatter, []

    def counting(*args, **kwargs):
        calls.append(1)
        return scatter(*args, **kwargs)

    TP.scatter = counting
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    finally:
        TP.scatter = scatter
    gathers = sum(e.count for e in prof.key_averages()
                  if e.key == "tp_gather" and e.device_type == DeviceType.CPU)
    return gathers, len(calls)


def logits_err(torch, got, want, rows=512):
    """(max |got - want|, max |want|) over the positions of (B, S, ...)
    tensors, compared ``rows`` positions at a time in float32."""
    err = scale = 0.0
    for i in range(0, want.shape[1], rows):
        a, b = got[:, i:i + rows].float(), want[:, i:i + rows].float()
        err = max(err, float((a - b).abs().max()))
        scale = max(scale, float(b.abs().max()))
    return err, scale


@contextlib.contextmanager
def first_block(torch):
    """Records the first block a forward runs (layer 0): its input and
    output (``blocks.block_fwd``), whole on the row's first device (a
    residual stream in sequence slices joined there)."""
    from repro_torch.models import blocks
    from repro_torch.models import tp as TP

    fn, seen = blocks.block_fwd, {}

    def recording(btype, params, cfg, x, positions, ctx, **kw):
        out = fn(btype, params, cfg, x, positions, ctx, **kw)
        if not seen:
            seen.update(x=TP.join_seq(x), out=TP.join_seq(out[0]))
        return out

    blocks.block_fwd = recording
    try:
        yield seen
    finally:
        blocks.block_fwd = fn


@contextlib.contextmanager
def attention_calls(torch):
    """Records each call of the attention entry point: (q's shape, k's
    shape, q's device, k's device)."""
    from repro_torch.kernels import ops

    fn, calls = ops.attention, []

    def recording(q, k, v, **kw):
        calls.append((tuple(q.shape), tuple(k.shape), q.device, k.device))
        return fn(q, k, v, **kw)

    ops.attention = recording
    try:
        yield calls
    finally:
        ops.attention = fn


def layer0_whole(torch, model):
    """Layer 0's parameters of the first group, a tensor-parallel model's
    slices joined onto its first device (the whole weights)."""
    from repro_torch.models import tp as TP
    from repro_torch.models.base import tree_map

    first = model.device
    block = next(iter(model.groups.values()))
    return tree_map(lambda t: torch.cat([p[0].to(first) for p in t.parts], t.dim - 1)
                    if isinstance(t, TP.Shards) else t[0], block.tree())


def layer0_f64(torch, cfg, w, x, top_e=None, ctx=None):
    """Block 0 (pre-norm attention and MLP, each with its residual add) in
    float64 on ``x`` (B, P, d) at positions 0..P-1, causal, with the whole
    weights ``w`` (each cast to float64 where it is used) → (B, P, d).  An
    MoE block (its experts padded at ``ctx``) takes ``top_e`` (the routing
    of the run it is held against: a near tie may route otherwise in
    float64), each token's weights from the float64 router."""
    import torch.nn.functional as F

    check(cfg.window is None, "layer0_f64 takes no window")
    xd = x.double()
    B, P, _ = xd.shape
    hd, half = cfg.head_dim, cfg.head_dim // 2

    def norm(p, t):
        if cfg.norm_type == "layernorm":
            mu = t.mean(-1, keepdim=True)
            var = (t - mu).square().mean(-1, keepdim=True)
            return (t - mu) * torch.rsqrt(var + 1e-5) * p["scale"].double() + p["bias"].double()
        return t * torch.rsqrt(t.square().mean(-1, keepdim=True) + 1e-6) * p["scale"].double()

    pos = torch.arange(P, dtype=torch.float64, device=x.device)
    inv = cfg.rope_theta ** (-torch.arange(half, dtype=torch.float64, device=x.device) / half)
    cos, sin = (pos[:, None] * inv).cos(), (pos[:, None] * inv).sin()

    def heads(h, wt, scale=None, rope=True):
        t = (h @ wt.double()).reshape(B, P, -1, hd)
        if scale is not None:
            t = t * torch.rsqrt(t.square().mean(-1, keepdim=True) + 1e-6) * scale.double()
        t = t.transpose(1, 2)
        if not rope:
            return t
        t1, t2 = t[..., :half], t[..., half:2 * half]
        return torch.cat([t1 * cos - t2 * sin, t2 * cos + t1 * sin, t[..., 2 * half:]], -1)

    a = w["attn"]
    h = norm(w["norm1"], xd)
    group = cfg.n_q_heads // cfg.n_kv_heads
    q = heads(h, a["wq"], a.get("q_norm"))
    k = heads(h, a["wk"], a.get("k_norm")).repeat_interleave(group, 1)
    v = heads(h, a["wv"], rope=False).repeat_interleave(group, 1)
    s = (q @ k.transpose(-1, -2)) * hd ** -0.5
    causal = torch.ones(P, P, dtype=torch.bool, device=x.device).tril()
    o = torch.softmax(s.masked_fill(~causal, float("-inf")), -1) @ v
    x1 = xd + o.transpose(1, 2).reshape(B, P, -1) @ a["wo"].double()
    del q, k, v, s, o
    h2 = norm(w["norm2"], x1)
    if "moe" in w:
        from repro_torch.models import moe

        p64 = {k: t.double() for k, t in w["moe"].items()}
        with routes_taken(torch, [top_e]):
            y, _ = moe.moe_ffn(p64, dataclasses.replace(cfg, dtype="float32"), h2, ctx)
        return x1 + y
    m = w["mlp"]
    if cfg.mlp_type in ("swiglu", "geglu"):
        g = h2 @ m["w_gate"].double()
        g = F.silu(g) if cfg.mlp_type == "swiglu" else F.gelu(g, approximate="tanh")
        hid = g * (h2 @ m["w_up"].double())
    else:
        hid = F.gelu(h2 @ m["w_up"].double(), approximate="tanh")
    return x1 + hid @ m["w_down"].double()


def tp_layer0(torch, cfg, model, x, outs):
    """Layer 0 on its input ``x`` against float64 with the whole weights
    (``model``'s slices joined), on the first TP_F64_POSITIONS positions →
    {label: max |err| / max |float64|} of each output in ``outs``."""
    P = TP_F64_POSITIONS
    with torch.no_grad():
        ref = layer0_f64(torch, cfg, layer0_whole(torch, model), x[:, :P])
        scale = float(ref.abs().max())
        errs = {k: float((o[:, :P].double() - ref).abs().max()) / scale for k, o in outs.items()}
    del ref
    torch.cuda.empty_cache()
    return errs


def tp_forward(torch, cut, model, tokens, ctx, mesh, vis):
    """The cache-free forward over ``mesh`` (its logits), with the attention
    entry point's calls and layer 0's input and output recorded: each
    layer's attention once a shard, at the shard's heads, on its device."""
    from repro_torch.models.lm import forward

    with torch.no_grad(), attention_calls(torch) as calls, first_block(torch) as seen:
        logits = forward(model, cut, tokens, ctx, mesh=mesh, vis_embeds=vis)[0]
    S = tokens.shape[-1] + (cut.n_vis_tokens if vis is not None else 0)
    hq = cut.n_q_heads // TP_SHARDS
    hkv = cut.n_kv_heads // TP_SHARDS if cut.kv_sharded(TP_SHARDS) else (
        1 if (cut.n_q_heads // cut.n_kv_heads) % hq == 0 else hq)
    want = [((1, hq, S, cut.head_dim), (1, hkv, S, cut.head_dim), mesh.device(0, s),
             mesh.device(0, s)) for _ in range(cut.n_layers) for s in range(TP_SHARDS)]
    check(calls == want, f"{cut.name}: the attention calls over the shards "
          f"{calls[:TP_SHARDS]}... ({len(calls)}), not once a layer a shard at {want[0][:2]}")
    return logits, seen


def tp_depths(torch, cut, models, tokens, ctx, mesh, vis, depths):
    """The cache-free forward of ``models`` (whole, sliced) cut to each of
    ``depths`` layers: {depth: (max |err| over the largest |logit|, the share
    of positions whose top token agrees)}."""
    from repro_torch.models.lm import forward

    out = {}
    for depth in depths:
        c = dataclasses.replace(cut, n_layers=depth)
        with torch.no_grad():
            want = forward(models[0], c, tokens, ctx, vis_embeds=vis)[0]
        got = tp_forward(torch, c, models[1], tokens, ctx, mesh, vis)[0]
        err, scale = logits_err(torch, got, want)
        top = float((got.argmax(-1) == want.argmax(-1)).float().mean())
        out[depth] = (err / scale, top)
        del got, want
    return out


def tp_decode_err(torch, cut, models, fns, prompt, whole_caches=None):
    """A greedy prefill and N_TOKENS decode steps of the sliced model, and
    the whole model's fed the same tokens → (the worst step's max |err| over
    its largest |logit|, prefill ms and ms a decode token, sliced then
    whole, the sliced model's cache after its last step).  ``whole_caches``
    (:func:`whole_cache_prefill`): the sliced model also decodes the same
    tokens from caches whole on the first device, and the walls end with
    its prefill ms and ms a decode token and the worst step's distance from
    the placed caches' logits over their largest |logit|."""
    toks, steps, pre_tp, dec_tp, cache = mesh_generate(torch, cut, models[1], *fns[1], prompt)
    _, want, pre_w, dec_w, _ = mesh_generate(torch, cut, models[0], *fns[0], prompt, feed=toks)
    errs = [logits_err(torch, a[:, None], b[:, None]) for a, b in zip(steps, want)]
    walls = (pre_tp, dec_tp, pre_w, dec_w)
    if whole_caches is not None:
        walls += whole_cache_decode(torch, cut, models[1], whole_caches, fns[1][1], prompt, toks,
                                    steps)
    return max(e / s for e, s in errs), walls, cache


def whole_cache_prefill(torch, cfg, ctx, mesh, capacity):
    """A prefill over ``mesh`` into caches whole on its first device
    (``lm.init_cache(..., device=mesh.first)``, the layout before the caches
    were placed; the mesh's decode fn reads them there)."""
    from repro_torch.models.lm import forward, init_cache

    def prefill(model, prompt):
        cache = init_cache(cfg, prompt.shape[0], capacity, device=mesh.first)
        start = torch.zeros((), dtype=torch.int32, device=mesh.first)
        with torch.no_grad():
            logits, cache, _ = forward(model, cfg, prompt, ctx, mesh=mesh, cache=cache,
                                       start_pos=start)
        return logits[:, -1], cache

    return prefill


def whole_cache_decode(torch, cfg, model, prefill, dec, prompt, toks, steps):
    """The placed caches' run (``toks``, each step's ``steps``) again from
    caches whole on the first device (:func:`whole_cache_prefill`), in the
    same process → (prefill ms, ms a decode token, the worst step's max
    |err| from the placed run's over its largest |logit|)."""
    _, got, pre, dec_ms, _ = mesh_generate(torch, cfg, model, prefill, dec, prompt, feed=toks)
    errs = [logits_err(torch, a[:, None], b[:, None]) for a, b in zip(got, steps)]
    return pre, dec_ms, max(e / s for e, s in errs)


@contextlib.contextmanager
def last_shard_dropped(torch):
    """The controls of phases 4l and 4m: every row-parallel sum over the
    model shards leaves out the last shard's part (``tp.reduce_sum`` drops
    it; ``tp.reduce_scatter_seq`` takes it as zeros, so that each shard
    still gets its slice)."""
    from repro_torch.models import tp as TP

    total, scatter = TP.reduce_sum, TP.reduce_scatter_seq
    TP.reduce_sum = lambda parts, device: total(parts[:-1], device)
    TP.reduce_scatter_seq = lambda parts, dim=1: scatter(
        [*parts[:-1], torch.zeros_like(parts[-1])], dim)
    try:
        yield
    finally:
        TP.reduce_sum, TP.reduce_scatter_seq = total, scatter


@contextlib.contextmanager
def seq_gathers():
    """Counts the calls of ``tp.all_gather_seq`` (sequence parallelism
    taken) into the list yielded."""
    from repro_torch.models import tp as TP

    calls, fn = [], TP.all_gather_seq

    def counting(*args, **kwargs):
        calls.append(1)
        return fn(*args, **kwargs)

    TP.all_gather_seq = counting
    try:
        yield calls
    finally:
        TP.all_gather_seq = fn


# the sliced loss against lm_loss on the same joined logits (float32, both
# on the card): its sums of exponentials run in another order
SEQ_LOSS_TOL = 1e-5
SEQ_LOSS_CONTROL = 1e-2  # a sum that drops the last shard's exponentials must read over it


def sp_forward_and_loss(torch, cut, model, ctx, mesh, batch):
    """Sequence parallelism on the card, at a model over ``mesh``'s shards:
    the cache-free forward's logits under SP against the whole-row path's
    (``lm.seq_parallel`` patched to False) on the same weights and tokens,
    bit for bit or within STEP_GRAD_TOL of the largest |logit| (printed
    either way); then ``lm_loss_sliced`` on the logits' TPT_SHARDS column
    slices against ``lm_loss`` on them joined, within SEQ_LOSS_TOL
    relative, and a control whose sum drops the last shard's exponentials,
    over SEQ_LOSS_CONTROL → (the logits' distance, the loss's, the
    control's)."""
    from repro_torch.models import lm
    from repro_torch.models import tp as TP

    t0 = time.perf_counter()
    tokens = batch["tokens"]
    with torch.no_grad():
        with seq_gathers() as calls:
            sp = lm.forward(model, cut, tokens, ctx, mesh=mesh)[0]
        check(len(calls) > 0, f"{cut.name}: the forward over {TPT_SHARDS} shards of "
              f"{tokens.shape[-1]} tokens did not take sequence parallelism")
        predicate = lm.seq_parallel
        lm.seq_parallel = lambda *a: False
        try:
            whole = lm.forward(model, cut, tokens, ctx, mesh=mesh)[0]
        finally:
            lm.seq_parallel = predicate
        same = torch.equal(sp, whole)
        err, scale = logits_err(torch, sp, whole)
        del whole
        labels = batch["labels"]
        want = float(lm.lm_loss(sp, labels, cut.vocab))
        parts = list(sp.reshape(*sp.shape[:2], -1).chunk(TPT_SHARDS, -1))
        got = float(lm.lm_loss_sliced(parts, labels, cut.vocab, cut.n_codebooks))
        total, seen = TP.reduce_sum, []

        def drop_exps(parts_, device):  # the first sum: the exponentials'
            seen.append(1)
            return total(parts_[:-1] if len(seen) == 1 else parts_, device)

        TP.reduce_sum = drop_exps
        try:
            bad = float(lm.lm_loss_sliced(parts, labels, cut.vocab, cut.n_codebooks))
        finally:
            TP.reduce_sum = total
        del sp, parts
    rel, bad_rel = abs(got - want) / abs(want), abs(bad - want) / abs(want)
    print(f"[tp-train] {cut.name}: the forward over {TPT_SHARDS} shards with the sequence in "
          f"slices ({len(calls)} sequence gathers) against the whole-row path: "
          + ("bit for bit" if same else f"max |err| {err} of the largest |logit| {scale}")
          + f"; the loss on the logits' {TPT_SHARDS} vocabulary slices {got} vs lm_loss on them "
          f"joined {want} ({rel} relative, limit {SEQ_LOSS_TOL}); a sum that drops the last "
          f"shard's exponentials {bad} ({bad_rel}, must be over {SEQ_LOSS_CONTROL}); took "
          f"{time.perf_counter() - t0} s", flush=True)
    check(same or err <= STEP_GRAD_TOL * scale, f"{cut.name}: the SP logits {err} from the "
          f"whole-row path's, over {STEP_GRAD_TOL} of the largest |logit| {scale}")
    check(math.isfinite(got) and rel <= SEQ_LOSS_TOL, f"{cut.name}: the sliced loss {got} vs "
          f"lm_loss {want}")
    check(bad_rel > SEQ_LOSS_CONTROL, f"{cut.name}: the loss without the last shard's "
          f"exponentials {bad} stayed within {SEQ_LOSS_CONTROL} of {want}")
    gc.collect()
    torch.cuda.empty_cache()
    return (0.0 if same else err / scale), rel, bad_rel


def tp_serving(torch, name, devices):
    """Phase 4l for one model: ``name`` at full width and tp_depth's depth,
    whole on the first device and in slices over ``make_mesh(1, 4,
    devices=devices)``; → the forward kernel's launches (all, tensor-core).
    The logits and the decode steps are held on the models cut to
    TP_HOLD_DEPTH layers: through the full depth of a random-weight model
    the two paths' roundings grow apart (the distances are printed at
    TP_DEPTHS and the full depth); layer 0 is held against float64.  The
    served caches lie by kv heads (each shard's bytes the reckoning from
    ``make_cache_specs`` after the prefill and after the last decode step),
    and a traced decode step joins only the head's logits and scatters
    nothing."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import ShardCtx, init_model
    from repro_torch.models import tp as TP
    from repro_torch.models.base import tree_flatten
    from repro_torch.models.lm import forward
    from repro_torch.serve import make_serve_fns

    cfg = get_config(name)
    r = tp_depth(cfg)
    cut = dataclasses.replace(cfg, n_layers=r["layers"])
    held = dataclasses.replace(cfg, n_layers=TP_HOLD_DEPTH)
    ctx = ShardCtx(tp=TP_SHARDS)
    mesh = make_mesh(1, TP_SHARDS, devices=devices)
    first = mesh.first
    t0 = time.perf_counter()
    whole = init_model(cut, ctx, seed=SERVE_SEED, device=first)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    model = init_model(cut, ctx, seed=SERVE_SEED, mesh=mesh)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    got, want = TP.shard_bytes(model.tree(), TP_SHARDS), tp_reckoning(cut, ctx)
    check(got == want, f"{name}: the shards hold {got} bytes, the placements reckon {want}")
    wleaves = dict(tree_flatten(whole.tree()))
    n_split = 0
    for path, leaf in tree_flatten(model.tree()):
        w = wleaves[path]
        if not isinstance(leaf, TP.Shards):
            check(torch.equal(leaf, w), f"{name} {path}: a whole leaf differs from the whole draw")
            continue
        n_split += 1
        n = leaf.shape[leaf.dim] // TP_SHARDS
        check(all(p.shape[leaf.dim] == n and p.numel() * TP_SHARDS == w.numel()
                  and torch.equal(p, w.narrow(leaf.dim, s * n, n))
                  for s, p in enumerate(leaf.parts)),
              f"{name} {path}: the slices are not the whole draw's quarters")
    print(f"[tp] {cut.name} at {cut.n_layers} of {cfg.n_layers} layers (whole + slices "
          f"{r['bytes']:.0f} bytes reckoned, limit {TP_BUDGET:.0f}), ShardCtx(tp={TP_SHARDS}) "
          f"over {[str(d) for d in mesh.devices]}: whole made in {t1 - t0} s, sliced in "
          f"{t2 - t1} s; {n_split} leaves in quarters equal to the whole draw's, each shard's "
          f"bytes {got} the placements' reckoning", flush=True)

    rng = np.random.default_rng(SERVE_SEED + 2)
    tokens = torch.as_tensor(rng.integers(0, cut.vocab, (1, REG_SEQ)), device=first)
    vis = vis_embeds(torch, cut, 1, first, seed=SERVE_SEED) if cut.n_vis_tokens else None
    S = tokens.shape[-1] + (cut.n_vis_tokens if vis is not None else 0)
    before = (fa.launches.value, fa.launches_wgmma.value)
    with torch.no_grad(), first_block(torch) as seen_whole:
        want_l = forward(whole, cut, tokens, ctx, vis_embeds=vis)[0]
    got_l, seen = tp_forward(torch, cut, model, tokens, ctx, mesh, vis)
    torch.cuda.synchronize()
    check(fa.launches.value - before[0] == fa.launches_wgmma.value - before[1]
          == cut.n_layers * (1 + TP_SHARDS), f"{name}: the two forwards' launches "
          f"{fa.launches.value - before[0]} ({fa.launches_wgmma.value - before[1]} on "
          f"attn_fwd_wgmma), not {cut.n_layers} + {cut.n_layers * TP_SHARDS}")
    check(bool(torch.isfinite(got_l).all()) and got_l.shape == want_l.shape,
          f"{name}: TP logits not finite or of shape {tuple(got_l.shape)}")
    err, scale = logits_err(torch, got_l, want_l)
    top = float((got_l.argmax(-1) == want_l.argmax(-1)).float().mean())
    del want_l
    l0 = tp_layer0(torch, cut, model, seen["x"], {"tp": seen["out"], "whole": seen_whole["out"]})
    del seen, seen_whole
    check(l0["tp"] <= TP_TOL, f"{name}: layer 0 over the shards max |err| {l0['tp']} of the "
          f"largest |float64| value, over {TP_TOL}")
    mesh2 = make_mesh(1, TP_SHARDS, devices=devices)
    again = tp_forward(torch, cut, model, tokens, ctx, mesh2, vis)[0]
    check(torch.equal(again, got_l), f"{name}: a repeat in a fresh mesh gave other logits")
    del again, got_l
    print(f"[tp] {cut.name}: cache-free forward over {S} positions, attention once a layer a "
          f"shard ({cut.n_layers * TP_SHARDS} attn_fwd_wgmma launches at 1 x "
          f"{cut.n_q_heads // TP_SHARDS} ({cut.n_kv_heads // TP_SHARDS}) x {S} x "
          f"{cut.head_dim}); layer 0 against float64 over {TP_F64_POSITIONS} positions (max "
          f"|err| over the largest |value|): over the shards {l0['tp']}, whole {l0['whole']} "
          f"(limit {TP_TOL}); a repeat in a fresh mesh bit for bit; at {cut.n_layers} layers "
          f"the logits against the no-mesh forward's {err / scale} of the largest |logit| "
          f"{scale}, top token equal at {top} of the positions", flush=True)

    dist = tp_depths(torch, cut, (whole, model), tokens, ctx, mesh, vis, TP_DEPTHS)
    with last_shard_dropped(torch):  # the control
        bad = tp_depths(torch, cut, (whole, model), tokens, ctx, mesh, vis,
                        (TP_HOLD_DEPTH,))[TP_HOLD_DEPTH][0]
    held_err = dist[TP_HOLD_DEPTH][0]
    check(held_err <= TP_TOL, f"{name} at {TP_HOLD_DEPTH} layers: TP logits max |err| "
          f"{held_err} of the largest |logit|, over {TP_TOL}")
    check(bad > TP_TOL, f"{name} at {TP_HOLD_DEPTH} layers: a TP sum that drops shard 3's "
          f"parts kept the logits within the limit ({bad})")
    print(f"[tp] {cut.name}: logits against the no-mesh forward, max |err| over the largest "
          f"|logit| (top token equal) by depth: " + json.dumps(dist) + f"; held at "
          f"{TP_HOLD_DEPTH} layers (limit {TP_TOL}), where a TP sum that drops shard 3's parts "
          f"reads {bad}", flush=True)

    def traced():
        with torch.no_grad():
            forward(model, cut, tokens, ctx, mesh=mesh2, vis_embeds=vis)

    wall, kern_ms, copy_ms, kern, spans = profiled(torch, traced, TP_SP_FORWARD_RANGES)
    torch.cuda.synchronize()
    n_all, n_wgmma = fa.launches.value - before[0], fa.launches_wgmma.value - before[1]
    print(f"[tp] {cut.name}: a traced forward over the shards {wall} ms wall, {kern_ms} ms of "
          f"kernels, {copy_ms} ms of copies; the moves' ranges (host ms, device ms): "
          + json.dumps(spans) + "; top kernels: "
          + json.dumps([(round(t, 3), k[:60]) for t, k in kern[:6]]), flush=True)

    prompt = torch.as_tensor(rng.integers(0, cut.vocab, (1, TP_PROMPT)), device=first)
    worst, seen = {}, []
    pos = torch.tensor(TP_PROMPT + N_TOKENS, dtype=torch.int32, device=first)
    nxt = torch.zeros((1, 1), dtype=torch.int32, device=first)
    for c in (held, cut):
        pre, dec = make_serve_fns(c, ctx, mesh=mesh, capacity=TP_CAPACITY)[:2]
        fns = (make_serve_fns(c, ctx, capacity=TP_CAPACITY)[:2],
               (checked_prefill(torch, c, pre, mesh, TP_CAPACITY, seen), dec))
        worst[c.n_layers], walls, cache = tp_decode_err(
            torch, c, (whole, model), fns, prompt,
            whole_caches=whole_cache_prefill(torch, c, ctx, mesh, TP_CAPACITY) if c is cut
            else None)
        if c is held:  # a decode step traced at the held depth (each layer's moves alike)
            gathers, scatters = decode_moves(torch, lambda: dec(model, cache, nxt, pos))
    last = cache_cards(torch, cut, cache, mesh, 1, TP_CAPACITY, "after the last decode step")
    del cache
    check(worst[TP_HOLD_DEPTH] <= TP_TOL, f"{name} at {TP_HOLD_DEPTH} layers: a decode step over "
          f"the shards moved {worst[TP_HOLD_DEPTH]} of the largest |logit| from the no-mesh "
          f"decode's, over {TP_TOL}")
    check(walls[6] <= TP_TOL, f"{name}: the decode from caches whole on the first device moved "
          f"{walls[6]} of the largest |logit| from the placed caches', over {TP_TOL}")
    check(gathers == 1 and scatters == 0, f"{name}: a decode step ran {gathers} tp_gather "
          f"ranges (only the head's logits may join) and {scatters} scatters: the attention "
          "joined its q, k, v or scattered its output")
    print(f"[tp] {cut.name}: make_serve_fns over the mesh, a {TP_PROMPT}-token prefill and "
          f"{N_TOKENS} greedy decode steps against the no-mesh decode fed the same tokens, worst "
          f"step's max |err| over its largest |logit|: {json.dumps(worst)} by depth (held at "
          f"{TP_HOLD_DEPTH}, limit {TP_TOL}); at {cut.n_layers} layers prefill TP {walls[0]} ms, "
          f"no mesh {walls[2]} ms; decode TP {walls[1]} ms a token, no mesh {walls[3]} ms; in the "
          f"same process over the mesh with the caches whole on the first device: prefill "
          f"{walls[4]} ms, decode {walls[5]} ms a token, its logits {walls[6]} of the largest "
          f"from the placed caches'; the caches by kv heads, each "
          f"shard's bytes the reckoning from make_cache_specs after the prefill {seen[-1]} and "
          f"after the last step {last}; a traced decode step at {TP_HOLD_DEPTH} layers: {gathers} "
          f"tp_gather range (the head's logits), {scatters} scatters", flush=True)
    del whole, model
    gc.collect()
    torch.cuda.empty_cache()
    return {"flash_attention": n_all, "flash_attention_wgmma": n_wgmma}


def tp_phase(torch, ops, dev):
    """Phase 4l: TP_MODELS served over four model shards emulated on the
    card; → the forward kernel's launches."""
    t0 = time.perf_counter()
    total = {"flash_attention": 0, "flash_attention_wgmma": 0}
    for name in TP_MODELS:
        for k, n in tp_serving(torch, name, [dev] * TP_SHARDS).items():
            total[k] += n
    print(f"[tp] phase 4l: {json.dumps(total)} forward launches; took "
          f"{time.perf_counter() - t0} s", flush=True)
    return total


# ---------------------------------------------------------------- phase 4m --

TPT_SHARDS = 4
TPT_SEQ = 4096
# qwen3_moe_30b_a3b and mamba2_2p7b at their first TPT_DEPTH layers, and
# recurrentgemma_9b's first pattern group, at full width: through more
# random-weight layers the TP and no-mesh paths' roundings grow apart (4l).
TPT_DEPTH = TP_HOLD_DEPTH
# each gradient leaf of a step over the model shards within TPT_GRAD_TOL of
# its largest |g| from the no-mesh step's: two bf16 paths that round
# differently, held as 4c's check 2 holds the kernels against the plain
# attention.  On an H100 (seed 12) qwen3_moe_30b_a3b's leaves read
# 0.0018-0.0173 (2-4 bf16 ulps of the largest |g|; w_up the worst), over the
# 2^-6 the SSD's C14 check takes; a TP sum that drops a shard reads 2.63.
TPT_GRAD_TOL = STEP_GRAD_TOL
TPT_RANGES = TP_RANGES + ("fsdp_gather", "fsdp_grad_add")
TPT_STEPS, TPT_CUT = 3, 2  # the run killed at step 2, resumed, against three steps
TPT_KERNELS = TRAINING + SERVING + SSD_BWD_ROWS
# mamba2_2p7b's 1,024-token prefill on one shard's heads (80 / 4): the SSD
# kernels' shape with the state placed by heads (phase 4m, held in phase 5)
TPT_SSD_SHARD = (1, TP_PROMPT, 20, 64, 128, 128, "bfloat16")
# the attention kernels at the shards' shapes of TP training (phase 4m and
# tools/tp_train_cards.py): qwen3_8b at tp 2, qwen3_moe_30b_a3b at tp 2 and
# 4, recurrentgemma_9b's local attention at tp 4
TPT_ATTN = {
    "qwen3_8b tp2": (1, 16, 4, 4096, 4096, 128, "bfloat16", True, None, 0),
    "qwen3_moe_30b_a3b tp2": (1, 16, 2, 4096, 4096, 128, "bfloat16", True, None, 0),
    "qwen3_moe_30b_a3b tp4": (1, 8, 1, 4096, 4096, 128, "bfloat16", True, None, 0),
    "recurrentgemma_9b tp4": (1, 4, 1, 4096, 4096, 256, "bfloat16", True, 2048, 0),
}


def tpt_cut(name):
    """Phase 4m's cut of ``name``: TPT_DEPTH layers, or one pattern group."""
    from repro_torch.configs import get_config

    cfg = get_config(name)
    return dataclasses.replace(cfg, n_layers=max(TPT_DEPTH, len(cfg.block_pattern)))


def tpt_batch(cfg, rows, dev, step=0):
    """``rows`` x TPT_SEQ tokens of the synthetic stream (seed TRAIN_SEED)."""
    from repro_torch.data import SynthSpec, batch_at
    from repro_torch.data.loader import to_device

    return to_device(batch_at(SynthSpec(vocab=cfg.vocab, seq_len=TPT_SEQ, batch=rows,
                                        seed=TRAIN_SEED), step), dev)


def counted(torch, ops, fn):
    """``fn()`` and the launches it made → (its result, {kernel: n})."""
    before = ops.launch_counts()
    out = fn()
    torch.cuda.synchronize()
    after = ops.launch_counts()
    return out, {k: after[k] - before[k] for k in after}


def whole_fingerprint(torch, tree, dev):
    """``fingerprint`` of each leaf whole, a placed one gathered onto
    ``dev`` a leaf at a time: the same whatever the layout."""
    from repro_torch.models.base import keystr, tree_flatten

    out = {}
    for path, leaf in tree_flatten(tree):
        t = leaf.whole(dev) if hasattr(leaf, "whole") else leaf
        out.update(fingerprint(torch, {keystr(path): t}))
        del t
    return out


def tpt_grads(torch, ops, cut, dev, decays=False):
    """One step's loss and gradient over ``make_mesh(1, TPT_SHARDS)`` on
    ``[dev] * 4`` against the no-mesh step's on the same weights (drawn from
    one seed; an MoE's no-mesh step takes the TP step's experts, as 4k's
    check 2 does), then a control whose TP sum drops the last shard's part
    → (launches of the TP step, its ms, the worst leaf ratio, the
    control's)."""
    from contextlib import nullcontext

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import ShardCtx, init_model
    from repro_torch.models import tp as TP
    from repro_torch.models.base import keystr, tree_flatten
    from repro_torch.train.trainstep import value_and_grad

    ctx = ShardCtx(tp=TPT_SHARDS)
    mesh = make_mesh(1, TPT_SHARDS, devices=[dev] * TPT_SHARDS)
    batch = tpt_batch(cut, 1, dev)
    model = init_model(cut, ctx, seed=TRAIN_SEED, trainable=True, mesh=mesh)
    if decays:
        mamba2_decays(torch, model, TRAIN_SEED)
    moe = cut.moe is not None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with routes_taken(torch) if moe else nullcontext([]) as calls, seq_gathers() as gathers:
        (tl, _, tg), launches = counted(torch, ops, lambda: value_and_grad(
            model, cut, batch, ctx, False, mesh))
    ms = (time.perf_counter() - t0) * 1e3
    check(len(gathers) > 0, f"{cut.name}: the TP step did not take sequence parallelism")
    replay = None
    if moe:  # each layer routed once a shard, the shards alike
        groups = [calls[i:i + TPT_SHARDS] for i in range(0, len(calls), TPT_SHARDS)]
        check(len(groups) == cut.n_layers and all(
            all(torch.equal(c[0], g[0][0]) for c in g) for g in groups),
              f"{cut.name}: the shards routed a layer's tokens differently")
        replay = [g[0][0] for g in groups]
    whole = init_model(cut, ctx, seed=TRAIN_SEED, device=dev, trainable=True)
    if decays:
        mamba2_decays(torch, whole, TRAIN_SEED)
    wleaves = dict(tree_flatten(whole.tree()))
    check(all(torch.equal(leaf.whole(dev), wleaves[p].detach())
              for p, leaf in tree_flatten(model.tree())),
          f"{cut.name}: the slices drawn over the shards are not the whole draw's")
    with routes_taken(torch, replay) if moe else nullcontext([]) as wcalls:
        wl, _, wg = value_and_grad(whole, cut, batch, ctx, False)
    moved = moved_tokens(torch, wcalls) if moe else []

    def ratios(grads):
        out = {}
        for (path, g), (_, w) in zip(tree_flatten(grads), tree_flatten(wg)):
            gw = g.whole(dev)
            out[keystr(path)] = float((gw - w).abs().max()) / max(float(w.abs().max()), 1e-30)
            del gw
        return out

    r = ratios(tg)
    worst = max(r.values())
    del tg
    with last_shard_dropped(torch):  # the control
        _, _, cg = value_and_grad(model, cut, batch, ctx, False, mesh)
    bad = max(ratios(cg).values())
    del cg, wg, whole, wleaves
    gc.collect()
    torch.cuda.empty_cache()
    seq = sp_forward_and_loss(torch, cut, model, ctx, mesh, batch)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[tp-train] {cut.name} at {cut.n_layers} layers, full width, 1 x {TPT_SEQ} tokens "
          f"over {TPT_SHARDS} shards on the card: the TP step {ms} ms, loss {float(tl)} vs the "
          f"no-mesh step's {float(wl)}; worst gradient leaf |err| / max |g| {worst} (limit "
          f"{TPT_GRAD_TOL}), a TP sum that drops shard 3's parts {bad}; {len(gathers)} sequence "
          f"gathers (SP)"
          + (f"; tokens whose no-mesh router would choose otherwise, by layer {moved}"
             if moe else "") + "; the TP step's launches "
          + json.dumps({k: n for k, n in launches.items() if n}) + "; by leaf "
          + json.dumps(r), flush=True)
    check(math.isfinite(float(tl)) and abs(float(tl) - float(wl)) <= STEP_LOSS_TOL * abs(
        float(wl)), f"{cut.name}: TP loss {float(tl)} vs the no-mesh step's {float(wl)}")
    check(worst <= TPT_GRAD_TOL, f"{cut.name}: a TP gradient leaf {worst} of its largest |g| "
          f"from the no-mesh step's, over {TPT_GRAD_TOL}")
    check(bad > TPT_GRAD_TOL, f"{cut.name}: a TP sum that drops shard 3's parts kept the "
          f"gradients within the limit ({bad})")
    return launches, ms, worst, bad, seq


def tpt_layouts(torch, ops, cut, dev):
    """AdamW steps of 2 x TPT_SEQ tokens (remat full) with the state over
    ``(2, 2)`` (TP × FSDP) against the same steps over ``(1, 2)`` with
    microbatches of one sequence (an MoE: on the whole batch, which its
    ``(2, 2)`` step routes on the first row at one capacity, as the
    reference's ``moe_ffn``), then over ``(2, 2)`` again from a fresh
    state: after the first step, params and moments bit for bit
    (fingerprints of the whole leaves) and each card's bytes the
    placements' reckoning; a second, warm step timed (the repeat's traced)
    → the launches of the six steps."""
    from repro_torch.configs import RunConfig
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train.trainstep import (card_state_bytes, init_placed_state,
                                             make_train_step)

    total = {}
    out = []
    whole_batch = cut.moe is not None
    for dp, micro, trace in ((2, None, False), (1, None if whole_batch else 1, False),
                             (2, None, True)):
        run = RunConfig(model=cut, shape=ShapeConfig("tp", "train", TPT_SEQ, 2), dp=dp, tp=2,
                        remat="full", microbatch=micro)
        mesh = make_mesh(dp, 2, devices=[dev] * (2 * dp))
        step, ctx = make_train_step(cut, run, mesh=mesh, opt=launcher_opt(TPT_STEPS))
        model, state = init_placed_state(cut, run, ctx, mesh, seed=TRAIN_SEED)
        held = card_state_bytes(model, state)
        want = tp_train_reckoning(cut, dp, 2, arrays=3)
        check(held == want, f"{cut.name} over ({dp}, 2): each card holds {held} bytes of the "
              f"state, the placements reckon {want}")
        torch.cuda.reset_peak_memory_stats()
        res, ms = [], []
        for i in range(2):
            batch = tpt_batch(cut, 2, dev, step=i)

            def run_step():
                res.append(step(model, state, batch))

            t0 = time.perf_counter()
            with seq_gathers() as gathers:
                if trace and i == 1:
                    traced, launches = counted(torch, ops, lambda: profiled(torch, run_step,
                                                                            TPT_RANGES))
                    wall, kern_ms, copy_ms, kern, spans = traced
                else:
                    _, launches = counted(torch, ops, run_step)
            check(len(gathers) > 0, f"{cut.name} over ({dp}, 2): the step did not take "
                  "sequence parallelism")
            ms.append((time.perf_counter() - t0) * 1e3)
            model, state, m = res.pop()
            for k, n in launches.items():
                total[k] = total.get(k, 0) + n
            if i == 0:
                fp = whole_fingerprint(torch, {"params": model.tree(), "mu": state["mu"],
                                               "nu": state["nu"]}, dev)
                out.append((fp, float(m["loss"]), float(m["grad_norm"])))
        print(f"[tp-train] {cut.name} over ({dp}, 2)" + (f", microbatch {micro}" if micro else
                                                          "") + f": step 1 {ms[0]} ms, loss "
              f"{out[-1][1]}, grad norm {out[-1][2]}; step 2 " + (
                  f"traced, {wall} ms wall, {kern_ms} ms of kernels, {copy_ms} ms of copies, "
                  "the moves' ranges (host ms, device ms): " + json.dumps(spans) if trace
                  else f"{ms[1]} ms, {2 * TPT_SEQ / ms[1] * 1e3} tokens/s") + f"; each card's "
              f"state {held} bytes (the reckoning), peak {torch.cuda.max_memory_allocated()} "
              "bytes", flush=True)
        del model, state, step, batch, res
        gc.collect()
        torch.cuda.empty_cache()
    check(out[0][0] == out[1][0] and out[0][2] == out[1][2],
          f"{cut.name}: the TP × FSDP step over (2, 2) differs from the TP step over (1, 2)")
    check(out[0] == out[2], f"{cut.name}: the (2, 2) step repeated gave other bits")
    print(f"[tp-train] {cut.name}: the six steps' launches "
          + json.dumps({k: n for k, n in total.items() if n}), flush=True)
    return total


def tpt_serve(torch, ops, cut, dev):
    """``cut`` served whole and over ``make_mesh(1, TPT_SHARDS)`` on
    ``[dev] * 4`` from one seed (the SSD / RG-LRU projections in slices, the
    caches where the reference places them: the SSD state by heads, RG-LRU's
    by width, each conv tail by channels, the conv and the scan run on each
    shard's part; RecurrentGemma's one-kv-head ring whole on the first
    device): a TP_PROMPT-token prefill and N_TOKENS greedy decode steps, the
    whole model's fed the same tokens, every step's logits within TP_TOL of
    the largest |logit|, each shard's cache bytes the reckoning after the
    prefill and after the last step; the SSD prefill's launches at the
    shard's heads (TPT_SSD_SHARD) → the TP run's launches."""
    import numpy as np

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import ShardCtx, init_model
    from repro_torch.models import tp as TP
    from repro_torch.models.base import tree_flatten
    from repro_torch.serve import make_serve_fns

    ctx = ShardCtx(tp=TPT_SHARDS)
    mesh = make_mesh(1, TPT_SHARDS, devices=[dev] * TPT_SHARDS)
    whole = init_model(cut, ctx, seed=SERVE_SEED, device=dev)
    model = init_model(cut, ctx, seed=SERVE_SEED, mesh=mesh)
    kind = cut.block_pattern[0]
    sliced = sorted({p[-1] for p, leaf in tree_flatten(model.tree())
                     if len(p) > 2 and p[2] == kind and isinstance(leaf, TP.Shards)})
    check(sliced == ["in_proj", "out_proj"], f"{cut.name}: the {kind} leaves in slices are "
          f"{sliced}, not in_proj and out_proj")
    prompt = torch.as_tensor(np.random.default_rng(SERVE_SEED + 3).integers(
        0, cut.vocab, (1, TP_PROMPT)), device=dev)
    pre, dec = make_serve_fns(cut, ctx, mesh=mesh, capacity=TP_CAPACITY)[:2]
    seen = []
    fns = [make_serve_fns(cut, ctx, capacity=TP_CAPACITY)[:2],
           (checked_prefill(torch, cut, pre, mesh, TP_CAPACITY, seen), dec)]
    shapes, record = recorder({"ssd_chunk_scan": ops.KERNELS["ssd_chunk_scan"]})
    with record():
        (toks, steps, pre_tp, dec_tp, cache), launches = counted(
            torch, ops, lambda: mesh_generate(torch, cut, model, *fns[1], prompt))
    last = cache_cards(torch, cut, cache, mesh, 1, TP_CAPACITY, "after the last decode step")
    del cache
    pre_wc, dec_wc, wc_err = whole_cache_decode(
        torch, cut, model, whole_cache_prefill(torch, cut, ctx, mesh, TP_CAPACITY), dec, prompt,
        toks, steps)
    _, want, pre_w, dec_w, _ = mesh_generate(torch, cut, whole, *fns[0], prompt, feed=toks)
    errs = [logits_err(torch, a[:, None], b[:, None]) for a, b in zip(steps, want)]
    worst = max(e / sc for e, sc in errs)
    ssd = shapes["ssd_chunk_scan"]
    if kind == "ssd":
        heads = cut.ssd.expand * cut.d_model // cut.ssd.head_dim // TPT_SHARDS
        check(ssd == [TPT_SSD_SHARD] * (cut.n_layers * TPT_SHARDS)
              and launches["ssd_chunk_scan_wgmma"] == launches["ssd_chunk_scan_inter"]
              == cut.n_layers * TPT_SHARDS and TPT_SSD_SHARD[2] == heads,
              f"{cut.name}: the prefill's SSD calls {ssd} and launches {launches}, not one a "
              f"shard a layer at {TPT_SSD_SHARD} on ssd_wgmma and ssd_scan")
    print(f"[tp-train] {cut.name} at {cut.n_layers} layers served over {TPT_SHARDS} shards on "
          f"the card ({kind} in_proj by columns, out_proj by rows, the state and conv tails over "
          f"the shards): a {TP_PROMPT}-token prefill and {N_TOKENS} decode steps against the "
          f"no-mesh model's fed the same tokens, worst step's max |err| over its largest |logit| "
          f"{worst} (limit {TP_TOL}); prefill TP {pre_tp} ms, no mesh {pre_w} ms; decode TP "
          f"{dec_tp} ms a token, no mesh {dec_w}; in the same process over the mesh with the "
          f"caches whole on the first device: prefill {pre_wc} ms, decode {dec_wc} ms a token, "
          f"its logits {wc_err} of the largest from the placed caches'; "
          f"each shard's cache bytes the reckoning from make_cache_specs after the prefill "
          f"{seen[-1]} and after the last step {last}; the SSD calls at "
          f"{sorted(set(ssd))}; launches " + json.dumps({k: n for k, n in launches.items() if n}),
          flush=True)
    check(worst <= TP_TOL and wc_err <= TP_TOL, f"{cut.name}: the served logits over the "
          f"shards {worst} of the largest |logit| from the no-mesh model's, and {wc_err} from "
          f"the caches whole on the first device, over {TP_TOL}")
    del whole, model, steps, want
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def tpt_resume(torch, ops, cut, dev, root):
    """``train_loop`` over ``(2, 2)`` on ``[dev] * 4`` with the state in
    slices (``fsdp``), TPT_STEPS steps of 2 x TPT_SEQ tokens; the same run
    killed at step TPT_CUT and resumed from its exit checkpoint into its
    slices in place: the losses, gradient norms and final checkpoint files
    byte for byte → the uninterrupted run's launches."""
    import filecmp
    import os
    import shutil

    from repro_torch.configs import RunConfig
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import SynthSpec
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train import loop

    run = RunConfig(model=cut, shape=ShapeConfig("tp", "train", TPT_SEQ, 2), dp=2, tp=2,
                    remat="full")
    data = SynthSpec(vocab=cut.vocab, seq_len=TPT_SEQ, batch=2, seed=TRAIN_SEED)

    def train(name, fail_at_step=None):
        return loop.train_loop(cut, run, data, total_steps=TPT_STEPS, ckpt_dir=str(root / name),
                               ckpt_every=50, opt=launcher_opt(TPT_STEPS), seed=TRAIN_SEED,
                               fail_at_step=fail_at_step, log_fn=lambda line: None, device=dev,
                               mesh=make_mesh(2, 2, devices=[dev] * 4), fsdp=True)

    whole, launches = counted(torch, ops, lambda: train("whole"))
    try:
        train("cut", TPT_CUT)
        check(False, f"{cut.name}: the run to be killed at step {TPT_CUT} was not")
    except RuntimeError as exc:
        check(str(exc) == f"injected node failure at step {TPT_CUT}", f"{cut.name}: {exc}")
    resumed = train("cut")
    name = f"step_{TPT_STEPS:08d}"
    files = sorted(os.listdir(root / "whole" / name))
    same = files == sorted(os.listdir(root / "cut" / name)) and all(
        filecmp.cmp(root / "whole" / name / f, root / "cut" / name / f, shallow=False)
        for f in files)
    print(f"[tp-train] {cut.name} through train_loop over (2, 2), TP × FSDP, {TPT_STEPS} steps "
          f"of 2 x {TPT_SEQ} tokens: step ms {json.dumps([t * 1e3 for t in whole.step_times])},"
          f" losses {json.dumps(whole.losses)}; killed at step {TPT_CUT} and resumed from step "
          f"{resumed.resumed_from}: losses {json.dumps(resumed.losses)}, the final checkpoint's "
          f"{len(files)} files byte for byte the uninterrupted run's: {same}", flush=True)
    check(resumed.resumed_from == TPT_CUT and resumed.losses == whole.losses[TPT_CUT:]
          and resumed.grad_norms == whole.grad_norms[TPT_CUT:] and same,
          f"{cut.name}: the run resumed at step {TPT_CUT} differs from the uninterrupted one")
    shutil.rmtree(root, ignore_errors=True)
    return launches


def tp_train_phase(torch, ops, dev):
    """Phase 4m: training (and the SSD / RG-LRU blocks' serving) over
    TPT_SHARDS model shards emulated on the card → the kernel launches of
    the steps over the shards."""
    t0 = time.perf_counter()
    total = {k: 0 for k in TPT_KERNELS}
    every = {}

    def add(launches):
        for k, n in launches.items():
            every[k] = every.get(k, 0) + n
            if k in total:
                total[k] += n

    moe = tpt_cut("qwen3_moe_30b_a3b")
    add(tpt_grads(torch, ops, moe, dev)[0])
    add(tpt_layouts(torch, ops, moe, dev))
    ssd = tpt_cut("mamba2_2p7b")
    add(tpt_serve(torch, ops, ssd, dev))
    add(tpt_grads(torch, ops, ssd, dev, decays=True)[0])
    add(tpt_resume(torch, ops, ssd, dev, CKPT_ROOT / "tp"))
    rg = tpt_cut("recurrentgemma_9b")
    add(tpt_serve(torch, ops, rg, dev))
    add(tpt_grads(torch, ops, rg, dev)[0])
    fwd, bwd = every["flash_attention"], every["flash_attention_bwd_dq"]
    print(f"[tp-train] phase 4m: launches " + json.dumps({k: n for k, n in every.items() if n})
          + f"; took {time.perf_counter() - t0} s", flush=True)
    check(fwd > 0 and fwd == every["flash_attention_wgmma"] and bwd > 0
          and bwd == every["flash_attention_bwd_dq_wgmma"] == every["flash_attention_bwd_dkdv"]
          == every["flash_attention_bwd_dkdv_wgmma"], "phase 4m: the attention launches are "
          "not all on the tensor-core kernels, or none was made")
    check(every["ssd_chunk_scan_wgmma"] > 0 and every["ssd_chunk_scan_bwd_chunk_wgmma"] > 0
          and every["ssd_chunk_scan_bwd_state_wgmma"] > 0
          and every["ssd_chunk_scan_bwd_chunk"] == every["ssd_chunk_scan_bwd_state"] == 0
          and every["ssd_chunk_scan_cells"] == every["ssd_chunk_scan_short"] == 0,
          "phase 4m: the SSD launches are not all on the tensor-core kernels, or none was made")
    return total


def card_setup(torch, sources=None):
    """How every run of these phases starts, the whole script's and a
    tool's: IEEE float32 products for the plain versions (no TF32), the
    kernel libraries of ``sources`` (every source if None) built from the
    checkout, one ``nvcc`` each, all at once, and the card's line printed
    → that line (``nvidia-smi``'s name and power limit)."""
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions: IEEE f32 products
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    built = _build.build_all() if sources is None else _build.build_all(sources)
    build_s = time.perf_counter() - t0
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(f"[build] {len(built)} kernel libraries compiled in {build_s} s "
          f"({', '.join(built) or 'cached'})")
    if "flash_attention" in _build.LOGS:
        # registers and spills of the attention kernels (ptxas -v); a kernel
        # with a producer warpgroup reports its launch bound's 168, and its
        # consumers raise theirs to 232 (setmaxnreg)
        print("[build] ptxas, attention kernels (registers, spill stores / loads in bytes): "
              + "; ".join(f"{n} {r}, {st}/{ld}" for n, r, st, ld in
                          ptxas_report(_build.LOGS["flash_attention"])), flush=True)
    if "ssd_bwd" in _build.LOGS:
        # the SSD backward's tensor-core kernels (a consumer warpgroup of the
        # chunk kernel, too, raises its registers to 232 with setmaxnreg)
        print("[build] ptxas, SSD backward tensor-core kernels (registers, spill stores / loads "
              "in bytes): " + "; ".join(
                  f"{n} {r}, {st}/{ld}" for n, r, st, ld in
                  ptxas_report(_build.LOGS["ssd_bwd"], r"ssd_bwd_(?:chunk|state)_wgmma")),
              flush=True)
    print(f"[card] {smi}", flush=True)
    return smi


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from repro_torch.frame import backend as BK
        from repro_torch.kernels import ops
    except ImportError as exc:
        print(f"chip_smoke: the repro_torch package is not beside this script ({exc})",
              file=sys.stderr)
        return 2
    check("jax" not in sys.modules, "jax was imported")
    dev = torch.device("cuda")
    K = {name: mod for name, mod in ops.KERNELS.items() if name not in TRAINING}

    # -- phase 1: build
    smi = card_setup(torch)

    # -- phase 2: parity on the card
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    errs = parity(torch, K, rng, dev)
    fused_parity(torch, ops, rng, dev)
    errs.update(attention_parity(torch, rng, dev))
    attention_in_new_thread(torch, rng, dev)
    errs.update(ssd_bwd_parity(torch, rng, dev))
    torch.cuda.synchronize()
    print(f"[parity] kernel vs plain passed for all {len(errs)} kernels in "
          f"{time.perf_counter() - t0} s; max |err|: " + json.dumps(errs), flush=True)

    # -- phase 3: main path
    shapes, record = recorder(K)
    t0 = time.perf_counter()
    ref, cold, launches, cold_lat = main_path(torch, ops, BK, record)
    print(f"[main] phase took {time.perf_counter() - t0} s", flush=True)

    trace_notebook(torch)

    # -- phase 3c: the notebook over a data mesh of four shards on the card
    t0 = time.perf_counter()
    shapes_mesh, record_mesh = recorder(K)
    for kernel, n in dist_phase(torch, ops, BK, record_mesh, smi).items():
        if kernel in DATAFRAME:
            launches[kernel] += n
    print(f"[dist] phase took {time.perf_counter() - t0} s", flush=True)

    # -- phase 3d: the engine's contracts on the card
    for kernel, n in contracts_phase(torch, ops, BK, ref, cold, cold_lat).items():
        launches[kernel] += n

    # -- phase 3b: the examples and the serve launcher
    t0 = time.perf_counter()
    for kernel, n in examples_on_card(torch, ops, BK).items():
        launches[kernel] += n
    print(f"[examples] phase took {time.perf_counter() - t0} s", flush=True)

    # -- phase 4: real mode
    real_mode(torch, ref)

    # -- phase 4b: serving
    t0 = time.perf_counter()
    from repro_torch.configs import get_config

    served = serving(torch, ops, get_config("mamba2_2p7b"), dev, record)
    launches.update({name: served[name] for name in SERVING})
    print(f"[serve] phase took {time.perf_counter() - t0} s", flush=True)

    # -- phase 4c: training
    t0 = time.perf_counter()
    for kernel, n in training(torch, ops, dev).items():
        launches[kernel] += n
    print(f"[train] phase took {time.perf_counter() - t0} s", flush=True)

    # -- phase 4d: serving granite-MoE and RecurrentGemma (no attention kernel
    # launches on a cached serving path: the counters must stay at 0)
    for name in HYBRID_SERVED:
        t0 = time.perf_counter()
        served = serving_hybrid(torch, ops, name, dev)
        for kernel in TRAINING:
            launches[kernel] += served[kernel]
        print(f"[serve-hybrid] {name} phase took {time.perf_counter() - t0} s", flush=True)

    # -- phase 4e: training RecurrentGemma, one pattern group
    t0 = time.perf_counter()
    for kernel, n in training_rg(torch, ops, dev).items():
        launches[kernel] += n
    print(f"[train-rg] phase took {time.perf_counter() - t0} s", flush=True)

    # -- phase 4f: training granite-MoE through the train launcher; the
    # attention launches on the JSON line are those of 3b, 4c, 4e, 4f, 4g and 4h
    t0 = time.perf_counter()
    for kernel, n in training_moe(torch, ops, dev).items():
        launches[kernel] += n
    print(f"[train-moe] phase took {time.perf_counter() - t0} s", flush=True)

    # -- phase 4g: the model mesh, four shards emulated on the card
    for kernel, n in mesh_phase(torch, ops, [dev] * MESH_TP).items():
        launches[kernel] += n

    # -- phase 4h: the train state in slices over four data rows on the card
    for kernel, n in fsdp_phase(torch, ops, [dev] * FSDP_DP).items():
        launches[kernel] += n

    # -- phase 4i: the roofline on the card (counts, not launches of the JSON line)
    roofline = roofline_phase(torch, ops, dev)

    # -- phase 4j: Mamba-2 trained at full width and depth through the SSD's
    # backward kernels (C14); its forward launches join 4b's on the JSON line
    t0 = time.perf_counter()
    for kernel, n in training_ssd(torch, ops, dev).items():
        launches[kernel] += n
    print(f"[train-ssd] phase took {time.perf_counter() - t0} s", flush=True)

    # -- phase 4k: the five registered models no earlier phase runs, served
    # and trained at full width; their training launches join the JSON line's
    for kernel, n in registry_phase(torch, ops, dev).items():
        launches[kernel] += n

    # -- phase 4l: tensor parallelism over four model shards emulated on the
    # card; its cache-free forwards' launches join the JSON line's
    for kernel, n in tp_phase(torch, ops, dev).items():
        launches[kernel] += n

    # -- phase 4m: training over four model shards emulated on the card (TP,
    # TP × FSDP; the SSD and RG-LRU projections in slices); its steps'
    # launches join the JSON line's
    for kernel, n in tp_train_phase(torch, ops, dev).items():
        launches[kernel] += n

    # -- phase 5: kernel vs plain, then timing, at the main path's shapes
    t0 = time.perf_counter()
    mp = main_path_parity(torch, K, shapes, rng, dev)
    for name in mp:
        errs[name] = max(errs[name], mp[name][0])
    mpc = main_path_parity(torch, {k: K[k] for k in DIST_KERNELS}, shapes_mesh, rng, dev)
    for name in mpc:
        errs[name] = max(errs[name], mpc[name][0])
    train_shapes = (TRAIN_ATTN, (2, 15, 5, 1024, 1024, 64, "bfloat16", True, None, 0), RG_ATTN,
                    (2, 16, 1, 1024, 1024, 256, "bfloat16", True, 2048, 0), MOE_ATTN,
                    (2, 24, 8, 1024, 1024, 64, "bfloat16", True, None, 0), WIDE_ATTN,
                    *REG_ATTN.values(), *TP_ATTN.values(), *TPT_ATTN.values())
    for name, e in attention_parity(torch, rng, dev, train_shapes, "training").items():
        errs[name] = max(errs[name], e)
    print(f"[shapes] kernel vs plain passed at every main-path shape in "
          f"{time.perf_counter() - t0} s: "
          + json.dumps({name: {"shapes": n, "max_abs_err": e} for name, (e, n) in mp.items()})
          + "; phase 3c's: "
          + json.dumps({name: {"shapes": n, "max_abs_err": e} for name, (e, n) in mpc.items()}),
          flush=True)
    tm = timings(torch, K, shapes, rng, dev)
    tm.update(attention_timings(torch, rng, dev))
    flush = torch.empty(32 << 20, dtype=torch.float32, device=dev)
    tm.update({f"flash_attention {name}": forward_timing(torch, rng, dev, shape, flush)
               for name, shape in TP_ATTN.items()})
    tm.update(reg_attention_timings(torch, rng, dev, flush, TPT_ATTN, "4m"))
    tm.update(ssd_bwd_timing(torch, rng, dev))
    tm.update(ssd_shard_rows(torch, K, rng, dev, flush, errs))
    for name, t in tm.items():
        print(f"[time] {name} shape {t['shape']}: kernel {t['ms']} ms, "
              f"plain {t['plain_ms']} ms, library {t['library_ms']} ms, "
              f"bound {t['bound'][0]} ms ({t['bound'][1]})")
    rows = [
        {
            "name": name,
            "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{SOURCES[name]}.cu",
            "replaces": REPLACES[name],
            "launches": launches[name],
            "max_abs_err": errs[name],
            "ms": tm[name]["ms"],
            "plain_ms": tm[name]["plain_ms"],
            "bound_ms": tm[name]["bound"][0],
            "bound_by": tm[name]["bound"][1],
            "library_ms": tm[name]["library_ms"],
        }
        for name in DATAFRAME + SERVING + TRAINING + SSD_BWD_ROWS
    ]
    print(json.dumps({"roofline": roofline}))
    print(f"{smi}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
