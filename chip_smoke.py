#!/usr/bin/env python3
"""Chip smoke of the PyTorch / CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing a line before the last:

1. device     -- ``nvidia-smi`` name and power limit, torch / CUDA versions;
                 fails without a CUDA device.
2. build      -- compiles every kernel source in ``repro_torch/kernels/csrc``
                 (one ``nvcc`` each, in parallel) into ``build/kernels/``.
3. kernels    -- each kernel against its plain PyTorch version on the card at
                 its path's shapes, in bf16 and fp32, with times (CUDA events,
                 L2 flushed before every launch) beside the plain version's,
                 ``scaled_dot_product_attention``'s (a yardstick the port never
                 calls; pages gathered first, an explicit boolean mask for
                 verify and tree) and the bound the card's memory rate and
                 peak give for the same work (its bytes and operations from
                 ``kernels/cost.py``): the paged decode / chunked-
                 prefill kernels at the serving shapes (the decode also
                 checked at lengths on the 64-key tile edges, GQA groups 1
                 and 7 at hd 128 and 64, and a 4,096-key table, timed there
                 and at one tile a CTA, every slot with lengths <= 0 exactly
                 zero; the prefill at GQA group 7, hd 64 and C = 64; both
                 also at dbrx-132b's GQA group 6, H = 48), flash
                 attention
                 forward and backward at the training shape (plus a ragged
                 case, a non-causal case at hd 128 and 64, the smallest
                 monolithic prefill bucket and a sequence shorter than one q
                 tile; TFLOP/s and the share of the bound; the same at B=1,
                 S=4096), the dense decode / chunked prefill at the draft
                 model's shapes and the dense target's H = 16, timed at both
                 (the decode also at the paged decode's extra shapes, lengths
                 past S and S = 4,096; the prefill at group 7, hd 64 and
                 C = 64 with chunks past S), the paged verify for
                 T = 2, 3, 5 and at the suffix prefill's bucket sizes T = 64,
                 128 (lengths up to and past the table), the paged tree
                 verify for a chain (bit-equal to verify at T = 5), a
                 branching and a 31-node tree (both also at GQA group 7,
                 hd 64, and at moonshot's group 1, 16 / 16 heads: T = 5,
                 the chain and the 31-node tree; timed also with every slot cut to one 64-key tile,
                 the longest slot alone, the 31-node tree, and at one tile
                 per split of the tensor-core body); the same for the dense
                 verify and tree verify over the target's dense rows (their
                 bf16 cluster kernel also beside the paged verify's
                 two-launch split over the same rows); the Mamba1 scan at
                 falcon-mamba's widths (fp32, B = 1 and 8, Q = 8 to 256; one
                 launch against chained 64-step launches; ds 4, 8 and 32 at
                 a ragged d_inner), timed at Q = 64 and 256.  Then a NaN at
                 one live K position of one slot, in bf16 and fp32, through
                 every attention kernel (#1-#9; flash forward causal and
                 non-causal, and backward): non-finite outputs exactly where
                 the plain version's are, every other slot bit-equal to the
                 call without the NaN.  Last, zamba2-2.7b's shared attention
                 at hd 80: flash forward and backward at its training shape
                 (B=4, H=32, S=1024), a ragged monolithic bucket (S=200) and
                 a non-causal ragged case, the dense decode at group 1 (H =
                 kvH = 32) at the serving lengths and the tile edges, in both
                 dtypes, a NaN in one slot through both, timed in bf16
                 beside SDPA and the bound (rows ``*_hd80``).  Then the
                 audio / VLM slice's shapes, the same way (rows ``*_hd64``
                 / ``*_g4``): flash at hd 64 (musicgen-large's training
                 shape B=4, H=32, S=1024 causal, a ragged causal case and a
                 monolithic bucket; a NaN in one row), the paged decode and
                 chunked prefill at musicgen's group 1 (32 heads of 64) and
                 pixtral-12b's group 4 (32 heads over 8 of 128), the paged
                 verify and tree verify at musicgen's, the dense decode at
                 pixtral's, each with a NaN in one slot.  Last, the scan's
                 backward (#10b, no TPU counterpart) against autograd of the
                 plain scan at falcon-mamba's training shape (B = 4, Q =
                 1024, fp32) and at Q = 200 (and ragged widths, and a
                 d_inner whose last thread-block cluster is partly empty),
                 from a non-zero h0 and final-state gradient, two launches
                 bit-equal, the forward with checkpoints bit-equal to the
                 serving forward, a NaN in one batch row (at step 37, and
                 at the last step) staying in that row's gradients; timed
                 beside the plain backward and its bound, with each
                 instantiation's registers and spills from ``ptxas``.  Last,
                 olmo-1b's serving attention (rows ``*_g1``): the paged
                 decode and chunked prefill at group 1, H = kvH = 16 heads of
                 128, in both dtypes (the decode also at the tile edges), a
                 NaN in one slot, timed in bf16 beside SDPA and the bound.
                 Then the serve steps' 8-bit cache (rows
                 ``decode_attention_fp8`` / ``decode_attention_partial_fp8``):
                 #3 and its partial form (16 and 2 blocks, merged) over e4m3
                 and e5m2 K / V rows with bf16 and fp32 q, at H = 8 and 16
                 over 8 KV heads of 128 and musicgen's 32 of 64, S = 512 and
                 4,096 with an empty slot, against the plain versions on the
                 same 8-bit cache (relative to max |out|: 2e-2 bf16, 1e-4
                 fp32) and a NaN code in one slot; timed at H = 16 beside #3
                 over the same values in a bf16 cache, the bytes bound and
                 SDPA over the cache widened to bf16 (the widening apart).
4. parity     -- a 2-layer, full-width qwen3-1.7b in fp32 runs the same work
                 with ``impl="cuda"`` and ``impl="torch"`` on the card: model
                 steps (K/V pools, decode logits, tokens), EngineCore token
                 streams (the cuda engine's decode graphs must have captured
                 one paged decode launch a layer and step), speculating
                 engines (draft-paired, n-gram, and the target as its own
                 draft) whose streams must also equal the
                 plain greedy engine's, the dense target layout under chunked
                 and monolithic prefill (plain, draft-paired, n-gram), the
                 paged engine with monolithic prefill and radix hits (suffix
                 prefill), and ``lm_loss`` with its gradients; a 2-layer,
                 full-width falcon-mamba-7b engine gives equal streams and
                 final states.
5. collocated -- qwen3-1.7b at full depth and width trains (fp32 params, bf16
                 compute, batch 4 x seq 1024) under ``SpecInFRuntime``, whose
                 bubbles a bf16 engine on the initial weights fills with an
                 offline backlog and online requests.  The DP profile is sized
                 from the train step's and the engine microstep's times
                 measured here (``measure_dp_profile``); Algorithm 1 runs
                 with its default settings.  Losses must be finite and
                 fall, offline tokens must be produced, online requests
                 must finish, and the paged and flash kernels must have
                 launched (plain versions never), every chunked prefill
                 through the tensor-core body.  One step under
                 ``remat_policy="dots"`` must give the loss and gradient
                 norm of ``"none"`` and launch the flash forward twice per
                 layer (run first, before the graph's pool holds the
                 step's activations).  The step is ``jitted()``: one CUDA
                 graph, captured at the profile's warm-up call, whose
                 replays the profile times and the runtime runs (one
                 capture required; its capture seconds, pool and
                 hand-written kernels a replay printed).  Then the
                 training goes on for ``SPEC_COLLOC_ITERS``
                 iterations with the speculating engine under the runtime's
                 gamma controller: online requests must finish, and offline
                 tokens and spec rounds be produced.  This phase runs before
                 any ``torch.profiler`` session: after one, every launch
                 costs more on the host, and its times are host-paced.
6. chaos      -- failure containment and crash recovery (``phase_chaos``),
                 also before any profiler session: fp32 sweeps at phase 4's
                 2-layer width with the NaN, allocator, revocation and
                 overrun faults armed (paged with graph-replayed decode,
                 dense, draft-paired), journal kill / replay on both
                 layouts, a snapshot round trip; bf16 at full depth one
                 chaos sweep (its fault-free run journaled, its radix cache
                 snapshotted) and phase 5's trainer under SpecInFRuntime
                 with early resume armed.
7. serve      -- qwen3-1.7b at full depth and width, bf16, serves 16 requests
                 through ``EngineCore.step()``; every request must finish,
                 both paged kernels must have launched (plain versions never)
                 and each decode graph must have captured one paged decode
                 launch a layer and step,
                 each bf16 chunked prefill through the tensor-core body (as in
                 phases 5, 8 and 9).
8. spec serve -- the same model and requests, paired with its 1-layer draft
                 model and ``proposer="auto"``; every request must finish, the
                 router must have run both proposers, and the dense decode,
                 dense prefill, paged verify and paged tree verify kernels must
                 have launched (plain versions never), each bf16 launch of a
                 prefill or paged verify kernel through the tensor-core body
                 (``ops.body_counts``; also in phases 5, 7 and 9).
9. dense target serve -- the same on the dense target layout
                 (``kv_page_size=0``): the dense decode, dense prefill, dense
                 verify and dense tree verify kernels must launch, each bf16
                 launch of a prefill or verify kernel through the
                 tensor-core body; then a short run with monolithic prefill
                 must launch the flash forward kernel, under the same rule.
10. ssm serve -- falcon-mamba-7b at full depth and width, bf16, serves 16
                 requests (dense state rows, monolithic bucket prefill); every
                 request must finish and the scan kernel must launch once per
                 layer and admission.
11. moe parity -- moonshot-v1-16b-a3b (64 experts, top 6) at 2 layers, full
                 width, fp32, impl="cuda" against impl="torch": model steps,
                 EngineCore streams and counters on the paged layout (decode
                 graphs: one paged decode launch a layer and step) and the
                 dense layout, plain, paired with the 1-layer MoE draft
                 and from the n-gram lookup (its lm_head tied to the
                 embedding, so greedy decoding repeats and the lookup
                 matches; reaching the chain and tree verify kernels at GQA
                 group 1), and under a capacity factor whose monolithic prefill drops
                 expert choices (``moe_dropped`` printed, > 0 required); then
                 qwen3-1.7b's ``decode_microstep`` (its own graph) against
                 the fused loop (equal streams and transfers).
12. moe serve -- moonshot-v1-16b-a3b at full depth and width (48 layers,
                 56 GB of bf16 weights), the serve phase's 16 requests, plain
                 and then speculating (``proposer="auto"``, 1-layer MoE
                 draft): every request finishes, the paths' kernels launch,
                 the router runs both proposers; the decode step (k=8
                 graph replay, 8 slots), ``decode_microstep`` (its graph)
                 and an eager ``T.decode_step`` beside the bytes bound (every expert read every step),
                 probed before the plain serve (so its timed run holds no
                 decode-graph capture); its profiled round comes in the
                 end-of-run profiler block.
13. moe train -- moonshot-v1-16b-a3b at full width, 2 layers, fp32 params +
                 AdamW, bf16 compute, 4 x 1024 tokens, 3 steps: finite loss
                 and moe_aux, a non-zero router gradient, the flash forward
                 and backward once a layer and step.
14. config serves -- dbrx-132b (full width, 4 of 40 layers; GQA group 6),
                 qwen2-7b and deepseek-coder-33b (full depth and width), bf16:
                 every request finishes, both paged kernels launch, the
                 decode graphs capture one launch a layer and step; the
                 decode step beside its bytes bound, probed first.
                 Phases 11-17 each free their weights before the next.
                 They run after phase 6 and before phase 7, so every time
                 they take comes before the first profiler session
                 (phase 7's).
15. hybrid parity -- zamba2-2.7b at full width, 12 of 54 layers (2 cycles,
                 so the shared block runs twice), fp32, impl="cuda" against
                 impl="torch": forward logits, a padded 128-bucket prefill
                 bit-equal to the unpadded 100-token one (logits and Mamba2
                 state), EngineCore streams on the dense layout (4 slots, 8
                 requests) equal; flash launched once per cycle and
                 admission, the dense decode once per cycle and step.
16. hybrid serve -- zamba2-2.7b at full depth, bf16, 8 slots, max_seq 512:
                 the decode step (graph-replayed) beside its bytes bound (every
                 weight but the embedding, the shared block 9 times, plus
                 each slot's SSM and conv state read and written), then
                 phase 10's 16 requests; every request finishes with 32
                 tokens, the launch counts as in phase 15.
17. hybrid train -- zamba2-2.7b at full depth and width under remat "full",
                 fp32 params + AdamW, bf16 compute, 4 x 1024 tokens, 3
                 steps: finite loss and gradient norm, peak memory, flash
                 forward twice and backward once a cycle and step.
18. audio / vlm parity -- musicgen-large and pixtral-12b at full width, 2
                 layers, fp32, impl="cuda" against impl="torch": logits
                 from stub-frontend embeddings (B=2, S=200); a prefill from
                 ``params["embed"]``'s rows bit-equal to one from the same
                 tokens; EngineCore streams on the paged layout (chunked)
                 and the dense layout (monolithic, fed embeddings), plain
                 and paired with ``draft_config``'s draft, equal.
19. musicgen serve -- musicgen-large at full depth, bf16 (6.5 GB), 8 slots,
                 max_seq 512, phase 7's traffic (EnCodec code ids) on the
                 paged layout, plain and with ``proposer="auto"``; the
                 decode step beside its bytes bound, probed first.
20. pixtral serve -- pixtral-12b at full depth, bf16 (24.5 GB), phase 7's
                 traffic on the paged layout, the decode step probed first;
                 then 4 requests on the dense layout with monolithic
                 prefill (the stub frontend's embeddings through flash).
21. audio / vlm train -- musicgen-large at full depth and pixtral-12b at 8
                 of 40 layers, full width, remat "full", fp32 params +
                 AdamW, bf16 compute, 4 x 1024 stub-frontend embedding
                 batches, 3 steps: finite loss, every leaf's gradient
                 non-zero but the unread embedding table's, flash twice
                 forward and once backward a layer and step; the batch's
                 host -> device copy timed.
                 Phases 18-21 each free their weights; they run after
                 phase 17 and before phase 7.
22. falcon train -- falcon-mamba-7b at 2 layers, full width, fp32:
                 ``lm_loss`` and every gradient with impl="cuda" (the scan
                 kernel with checkpoints and its backward kernel) against
                 impl="torch"; then 24 of 64 layers at full width under
                 remat "full", fp32 params + AdamW, bf16 compute, 4 x 1024
                 tokens, 3 steps: finite loss and gradient norm, peak
                 memory, 2 forward scans and 1 backward a layer and step.
23. recurrent spec parity -- falcon-mamba-7b at 2 layers and zamba2-2.7b at
                 12 of 54, full width, fp32, each with ``draft_config``'s
                 draft, ``proposer="auto"``: streams cuda == torch == the
                 plain greedy engine's, drafted > accepted (the state
                 rollback ran).
24. recurrent spec serve -- both at full depth, bf16, phase 10's 16
                 requests of 32 new tokens with ``proposer="auto"``: every
                 request finishes; the scan once per layer of target and
                 draft and admission (falcon-mamba), flash once per cycle
                 of each and admission and the dense decode (zamba2).
                 Phases 22-24 each free their weights; they run after
                 phase 21 and before phase 7.
25. olmo parity -- olmo-1b (16 MHA heads of 128, a non-parametric
                 LayerNorm, tied embeddings) at 2 layers, full width, fp32,
                 impl="cuda" against impl="torch": model steps and the fused
                 loop (``_model_step_parity``), EngineCore streams on the
                 paged layout (decode graphs: one paged decode launch a
                 layer and step), ``lm_loss`` and every gradient (flash once
                 a layer each way).
26. olmo serve -- olmo-1b at full depth, bf16, a ``CONFIG_SERVES`` row (8
                 slots, 8 requests of 16 tokens): every request finishes,
                 both paged kernels launch; the decode step beside its bytes
                 bound (the tied table read once, as the unembedding).
27. olmo train -- the training CLI (``repro_torch.launch.train.main``) at
                 olmo-1b's full depth (1.18 B params, fp32 + AdamW, bf16
                 compute, remat "full", 4 x 1024, 6 steps), plain and with
                 ``--collocate``: finite losses, the flash forward twice and
                 the backward once a layer and step (the collocated run's
                 two calibration steps included), the plain versions never;
                 step times and peak memory logged.  Then the ``Trainer`` at
                 2 of 16 layers, full width, ``grad_compression="int8_ef"``:
                 an uninterrupted run on the eager step (the EF identity
                 ``deq + err_new == g + err_old`` exact on every leaf, read
                 on the host), then the Trainer's ``jitted()`` step with a
                 checkpoint every 4 steps (~3.8 GB each, in a temporary
                 directory) and a failure injected at step 5: one capture,
                 the losses bit-equal to the uninterrupted run's through
                 the restore (and within 1e-6 relative); the saves' and the
                 restore's seconds and bytes logged.
                 Phases 25-27 each free their weights; they run after
                 phase 24 and before phase 7, each timed.
28. policies  -- right after phase 6, over phase 5's measured DP profile
                 (its bubbles synthetic: comm_s = compute_s / 2, one card
                 has no collective) and microstep, plus one online service
                 time measured on an idle engine (a 40-token prompt, 8 new
                 tokens, after a warm-up): ``core.simulator.simulate`` for
                 SpecInF, MPS, TGS, Co-Exec and Exclusive, 30 simulated
                 seconds each, one offline instance (SpecInF also at 2 and
                 4) and 600 Poisson online requests over 3 instances.
                 Asserts: inputs and results finite (an online p95 NaN only
                 where a policy served none), each ``train_throughput_norm``
                 in (0, 1 + 1e-9], Exclusive's ``offline_norm`` within 5 %
                 of its normalisation point (the microstep over its whole
                 ticks), a repeat of the SpecInF run equal.  Prints each
                 policy's numbers, the two headline ratios (SpecInF / TGS
                 offline throughput, 1 - SpecInF p95 / MPS p95), the paper's
                 orderings (not asserted: the calibration was fitted to the
                 paper's A100) and the analytic H100 profiles beside the
                 measured step (MFU) and microstep.
29. online serving -- after phase 27: ``examples/torch_online_serving.py``'s
                 ``run`` at olmo-1b's full depth and width (remat "full",
                 4 x 1024) over the profile and microstep it measures, 12
                 iterations under ``SpecInFRuntime(busy_hold_ms=5)`` and 12
                 Poisson ONLINE requests.  Asserts: all 12 served, finite
                 losses, the paged decode / prefill and the flash forward /
                 backward launched.  Prints p95 latency and TTFT (virtual),
                 the wall time and the peak memory.
30. scale out -- after phase 29, one rank over NCCL (a ``FileStore`` in a
                 temporary directory): olmo-1b at full depth and width under
                 the train CLI's non-smoke settings (FSDP + ZeRO-1, remat
                 "full", fp32 params + AdamW, bf16 compute, 4 x 1024) through
                 a ``Trainer`` on ``make_dev_mesh()``, 3 steps against
                 ``make_train_step`` without a mesh from the same seed and
                 batches: losses, grad norms and every parameter and moment
                 bit-equal; then ``Trainer.remesh`` onto ("pod", "data") =
                 (1, 1) and one more step, bit-equal.  Prints both step
                 times, the peak memory and the collectives of each step.
31. collocated step -- ``make_collocated_step`` over phase 30's step (the
                 trainer's ``jitted()`` one) and k = 0, 2, 8 greedy bf16
                 ``decode_step``s of its weights on 8 dense rows (the dense
                 decode #3), the chain a CUDA graph a k replayed on a second
                 stream, every call on a fresh cache of the one shape (the
                 graph copies it into its own buffers: one capture a k):
                 the train result bit-equal across k and to the step alone,
                 the tokens equal to the eager chain's, each chain graph
                 bit-equal to its eager call; then ``F1_CYCLES`` more rounds
                 of fresh caches: tokens equal, one capture and one live
                 graph a k, device memory flat.  Prints fused[k]'s time
                 beside the step and the eager chain alone, each graph's
                 eager and replay ms, launches, capture s and pool bytes,
                 and the bytes allocated after each round.
32. model axis kernels -- after phase 31: #3's partial form (the
                 sequence-parallel decode over a model axis) over m = 2, 4
                 and 16 contiguous blocks of qwen3-1.7b's decode cache (B =
                 8, H = 16, kvH = 8, hd 128; S = 512 and 4,096; bf16 and
                 fp32; rows whose length leaves whole blocks empty), merged
                 by ``paged::combine_splits``: against #3 over the whole
                 cache (bf16 2e-2, fp32 1e-5) and the plain partial and
                 merge, a NaN in one slot; one block's partial and the merge
                 timed beside #3 over the whole cache; flash forward and
                 backward at olmo-1b's local head counts (8 and 1; B = 4, S
                 = 1024, causal) against the plain version; then the port's
                 own sequence-parallel decode: ``make_prefill_step`` and 8
                 ``make_serve_step`` steps of qwen3-1.7b at full width and
                 depth in fp32 on a (data, model) = (1, 16) stand-in mesh,
                 its ranks threads of this process run in turn, each
                 holding 32 of the cache's 512 rows: tokens equal to the
                 unsplit ``T.prefill`` + ``T.decode_step``, the logits and
                 the gathered cache within 1e-4 of their max.  The rows
                 ``decode_attention_partial`` (beside the memory-efficient
                 SDPA call with its logsumexp over the same block) and
                 ``combine_splits`` report that run's launches.
33. serve steps -- on phase 30's one-rank NCCL mesh: ``make_prefill_step``
                 and 32 ``make_serve_step`` steps at olmo-1b's and
                 qwen3-1.7b's full width and depth in bf16 (8 rows of a
                 128-token prompt, seq_len 512): the tokens bit-equal to
                 ``T.prefill`` plus eager ``T.decode_step``, no collective
                 issued; prints each step's time beside the eager step's,
                 the peak memory, the collectives a step; then
                 ``F1_CYCLES`` cycles of the same prefill and steps through
                 ``jitted()`` (CUDA graphs, one capture each: each
                 prefill's new cache copied into the decode graph's
                 buffers): logits and tokens equal to the eager step's in
                 every cycle, one live graph each, device memory flat
                 after the first cycle, each graph bit-equal to its eager
                 call.  Then the
                 same with ``cache_dtype=float8_e4m3fn`` (``jitted()`` too): the prefill's cache bit-equal
                 to ``T.prefill``'s, each step's tokens against the same step
                 on the plain versions (equal in fp32 compute; in bf16 apart
                 only at a bf16 tie), the first step's logits cosine >= 0.98
                 against the bf16 cache's, cache bytes, peak and step time
                 beside the bf16 cache's, and qwen3-1.7b's 8 x 4,096 cache in
                 both types; the sequence-parallel decode over an 8-bit cache
                 (qwen3-1.7b cut to 2 layers on the (1, 16) stand-in: the
                 fp8 rows' launches); and the FSDP serve steps of qwen3-1.7b
                 (full depth, fp32) on a (data, model) = (4, 1) stand-in:
                 tokens equal to the unsplit run, each rank's most gathered
                 bytes alive at once within one layer's plus the table.
34. ssm model axis -- after phase 33: ``make_prefill_step`` and 8
                 ``make_serve_step`` steps of falcon-mamba-7b and
                 zamba2-2.7b at full width and depth in fp32 on a (1, 4)
                 stand-in mesh (phase 32's), each rank on its block of
                 ``d_inner`` (2048 and 1280 columns; zamba2's 32 attention
                 heads, KV heads too, 8 a rank): tokens equal to the unsplit
                 run, the logits and every gathered cache leaf within 1e-4
                 of their max, the scan launched once a layer and rank, the
                 hybrid's flash once a cycle and rank, its decode once a
                 cycle, rank and step; then the scan #10 and its backward
                 #10b at a rank's d_inner (2048, 4096: B = 4, Q = 1024 and
                 200; the smoke config's 32 at ds 8) against the plain scan
                 and autograd of it, two launches bit-equal, timed at Q =
                 1024 beside the plain versions and the bounds.  The row
                 ``ssm_scan_di2048`` reports the falcon-mamba stand-in run's
                 launches.
35. cost model -- first in the end-of-run profiler block, on a one-rank
                 NCCL mesh as phases 30-34's: olmo-1b at full depth, phase
                 30's train step (4 x 1024, FSDP + ZeRO-1, remat "full") and
                 phase 33's bf16 prefill and decode step (8 rows, 512-row
                 cache), each counted by ``launch.cost`` at the same shapes
                 on a (1, 1) recording mesh (``meta`` tensors), timed warm,
                 then run once under ``torch.profiler``: every hand-written
                 kernel's counted launches must equal the profiler's count
                 of it; prints the counted against the profiled launches of
                 all kernels, the counted peak against
                 ``max_memory_allocated``, the counted FLOPs and bytes, the
                 three roofline terms on ``core.hardware.H100``, the measured
                 step, its ``mfu`` (model FLOPs / (step s x 989e12)) and the
                 bound's share of it.
36. graphs    -- after phase 34, before phase 7 (no profiler session
                 before it): the engine's serving programs, captured as
                 CUDA graphs (every earlier serve phase already runs
                 through them), at full depth in bf16: qwen3-1.7b paged
                 and dense, chunked, plain and paired with its draft
                 (chunk waves of both models, the spec loop, the decode
                 loop), paged monolithic with radix hits (bucket, suffix
                 and draft bucket prefills), falcon-mamba-7b and
                 zamba2-2.7b (bucket prefill, recurrent decode loop);
                 qwen3-1.7b with the n-gram lookup, paged and dense (width
                 2), greedy: one tree-round graph per (parents, mode) run;
                 the "simulated" tree rounds graphed and eager from one
                 generator seed (streams, rounds and acceptance equal);
                 ``decode_microstep``'s graph (streams equal to an eager
                 engine's).  Every captured program, on its last inputs and a cache
                 snapshot, must give outputs and cache entries bit-equal to
                 its eager call (a paged pool's sentinel page apart: pad
                 rows collide there); prefill graphs must equal
                 ``prefill_compile_count``; the "sample" spec mode's stream
                 through graphs (the engine's generator registered) must
                 equal an eager engine's from the same seed.  Prints each
                 program's eager and replay ms (median of 5), launches a
                 replay (counted by ``launch.cost``), capture seconds, the
                 pool's bytes, and phase 28's service probe eager and
                 graphed.
37. train graphs -- after phase 36, before phase 7: the train step
                 through ``TrainStepArtifacts.jitted()``, one CUDA graph a
                 state (forward, backward, collectives, int8 EF, clip,
                 schedule, AdamW), at 4 x 1024, fp32 params + AdamW:
                 qwen3-1.7b at full depth (phase 5's step), falcon-mamba-7b
                 at phase 24's 24 of 64 layers (the scan with checkpoints
                 and its backward), moonshot-v1-16b-a3b at 2 layers (MoE),
                 zamba2-2.7b (flash at hd 80, remat "full"), musicgen-large
                 (embedding inputs; zamba2 at 18 of 54 layers, musicgen at
                 12 of 48) and olmo-1b under remat "dots": each
                 step counted by ``launch.cost``, then 3 steps eager, 3
                 graphed (one capture) and 3 more on the same graph after
                 the seed's state is copied back in place: losses, grad
                 norms and every state leaf bit-equal to the eager run's
                 (where two eager runs differ, within their gap, printed);
                 olmo-1b's eager and replayed steps timed by section
                 (forward, backward, clip, AdamW; ``cudaMalloc`` calls).
                 Then the ``Trainer`` (olmo-1b at 2 layers, int8_ef, two
                 microbatches) against an eager twin through a failure
                 and restart and a remesh none -> a one-rank NCCL mesh
                 (FSDP + ZeRO-1) -> none: losses and state bit-equal, one
                 capture a state, device memory flat across the round
                 trip.  Prints eager and replay ms (median), launches a
                 replay, capture s, pool bytes and peaks.

Then, under ``torch.profiler``, a serving round of phase 12's moonshot
engine and of phase 16's zamba2 engine (each rebuilt from the same seed),
one train step of phase 5's model and one of phase 17's (the device's busy
share and the flash kernels' share of device time),
the flash backward's three kernels one by one, the paged verify's and
tree verify's split pass and combine apart, the dense verify's and
tree verify's one cluster kernel, and the paged and dense decode's one
cluster kernel (a call must be that one kernel and one allocation, its
output); one
``{"kernels": [...]}`` line (launches from the run of each
kernel's path: the speculative kernels' from the spec serve run -- the
dense decode's and prefill's also from the dense target serve run --, the dense
verify and tree verify from the dense target serve run, the scan from the
ssm serve run, the hd-80 rows' from phases 16 (decode) and 17 (flash),
the ``*_hd64`` rows' from phases 21 (flash) and 19 (the others), the
``*_g4`` rows' from phase 20, the scan backward's from phase 22's
24-layer run, the ``*_g1`` rows' from phase 26, the others' from the
collocated run; each
row also gains ``launches_<run>`` for the runs of phases 12-14, 16-17,
19-21, 22-24, 26-27, 29-31, 33, 34 and 37 that launch it; phase 32's two rows,
#3's partial form and the merge, report its sequence-parallel serve run's
launches, phase 34's row its falcon-mamba run's, the two 8-bit rows phase
33's 8-bit runs'; a row with no launch fails the run)
and, last,
the
``{"ok": true, ...}`` line.  Any failed
phase raises and the script exits non-zero.  It imports nothing of JAX or
of the ``repro`` package.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
#: H100 SXM device-memory rate and dense peaks (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS_BF16 = 989e12
PEAK_FLOPS_FP32 = 67e12
#: bf16 kernel vs the fp32 plain version on the same bf16 inputs: the kernel
#: rounds its output to bf16 (relative 2^-8 on |out| <~ 3)
BF16_ATOL = 2e-2
#: fp32 kernel vs fp32 plain version: same math, sums in another order
FP32_ATOL = 1e-4
#: fp32 model logits, impl="cuda" vs impl="torch": attention differences of
#: ~1e-6 carried through 2 layers and a 151936-way unembedding
LOGITS_ATOL = 1e-3

#: fp32 gradients, kernel vs plain version: relative to the largest |g|
GRAD_RTOL_FP32 = 1e-4
#: bf16 gradients: each dQ / dK / dV is rounded to bf16 once (relative 2^-9)
#: on top of D = rowsum(dO * O) taken from the bf16 output
GRAD_RTOL_BF16 = 2e-2
#: a full-depth bf16 train step's loss and gradient norm, remat "dots" vs
#: "none": the same kernels on the same inputs, sums possibly in another
#: order; one bf16 rounding step (2^-8) relative
LOSS_RTOL_BF16 = 2.0**-8

# kernel-phase shapes: the serving path's (qwen3-1.7b attention, 16-token
# pages, 32 table columns + sentinel = max_seq 512, 8 slots, 32-token chunks)
B, H, KVH, HD, PAGE, NCOLS, CHUNK = 8, 16, 8, 128, 16, 32, 32
DECODE_LENGTHS = [512, 300, 0, 17, 1, 256, 511, 100]
PREFILL_STARTS = [0, 64, 100, 480, 0, 33, 256, 16]
PREFILL_LENS = [32, 0, 17, 32, 1, 5, 32, 20]
SHARED_PAGES = 4  # slot 1's first pages are slot 0's (a radix-shared prefix)
# decode check shapes beyond the serving ones: lengths at the 64-key tile
# edges (0, 1, 63, 64, 65, 127, 129, the full table; dense also past S),
# groups 1 and 7, hd 64, and a 4,096-key table / S (8 tiles a CTA)
DECODE_EDGE_LENGTHS = [63, 64, 65, 0, 1, 512, 127, 129]
DENSE_EDGE_LENGTHS = [63, 64, 65, 0, 1, 512, 600, 129]
LONG_NCOLS, LONG_S = 256, 4096
# dbrx-132b's attention: GQA group 6 (48 q heads over 8 kv heads of 128); the
# decode's rows-per-CTA plan gives G = 4 over 2 passes, the second with 2
# live rows, and a 32-token chunk's 192 rows fill three 64-row tiles
GROUP6_CASE = (" (group 6, H=48)", {"h": 48})
LONG_LENGTHS = [4096, 3000, 0, 17, 1, 2048, 4095, 1000]
# chunked prefill at C = 64 (two q tiles of 64 rows at group 2); on the
# dense cache slots 3 and 7 run past S
PREFILL_STARTS_C64 = [0, 64, 100, 448, 0, 33, 256, 16]
PREFILL_STARTS_C64_DENSE = [0, 64, 100, 480, 0, 33, 256, 490]
PREFILL_LENS_C64 = [64, 0, 17, 64, 1, 5, 63, 40]
# flash attention: the training shape (batch 4 x seq 1024, qwen3's 16 heads
# of 128 after the GQA expand), plus a ragged case, a non-causal case at
# both head dims, the smallest monolithic prefill bucket and a sequence
# shorter than one 128-row q tile
TRAIN_B, TRAIN_S = 4, 1024
FLASH_CASES = (  # (B, H, Sq, Sk, causal, hd)
    (TRAIN_B, H, TRAIN_S, TRAIN_S, True, HD),
    (2, H, 1000, 1000, True, HD),
    (2, H, 512, 1000, False, HD),
    (2, H, 512, 1000, False, 64),
    (4, H, 8, 8, True, HD),
    (8, H, 64, 64, True, HD),
)
# speculative slice: the draft model's dense cache (qwen3-1.7b's draft has
# 8 q / 8 kv heads of 128; max_seq 512) and the target's verify chunks over
# the serving pool (T = gamma + 1 for gamma in GAMMA_BUCKETS)
DRAFT_H, DENSE_S = 8, 512
DENSE_LENGTHS = [0, 512, 300, 17, 1, 256, 511, 100]  # empty and full slots
VERIFY_TS = (2, 3, 5)
VERIFY_LENGTHS = [1, 300, 4, 0, 512, 17, 256, 100]  # slot 0: lengths < T
# a suffix prefill after a radix hit verifies a whole bucket at once
# (lengths = shared pages + bucket, unclamped): chunks past kVerifyRows = 32
# rows spread over several row blocks; lengths < T, == the table and past it
SUFFIX_LENGTHS = {
    64: [64, 128, 160, 512, 544, 80, 3, 0],
    128: [128, 256, 144, 512, 608, 640, 5, 0],
}
# dense target slice: the target's verify chunks over its dense rows (qwen3's
# 16 q / 8 kv heads of 128, max_seq 512); the Mamba1 scan at falcon-mamba's
# widths (d_inner 8192, ssm_state 16), B = 1 as one admission runs it and
# B = 8, over the engine's smallest bucket (8), a 64-step chunk (the table's
# row), one step past it, and whole buckets of 128 and 256 steps; then the
# other state widths at a d_inner that leaves a ragged 32-row block (100) or
# is not a multiple of 4 (99: the 4-byte copies)
SSM_Q, SSM_DI, SSM_DS = 64, 8192, 16
SSM_QS = (8, 64, 65, 128, 256)
SSM_BATCHES = (1, 8)
SSM_SMALL = ((4, 100), (8, 99), (32, 100))  # (ds, di) at B = 2, Q = 65
#: fp32 scan kernel vs plain version: relative to max |y| (max |h|)
SSM_RTOL = 1e-5
#: fp32 scan backward vs autograd of the plain scan: relative to max |g|
#: (sums over d_inner and over the steps in another order)
SSM_GRAD_RTOL = 1e-4
SPEC_COLLOC_ITERS = 4
COLLOC_ITERS = 8
# zamba2-2.7b's shared attention: 32 MHA heads of 80.  Flash (#5) at its
# training shape and at a ragged monolithic bucket (plus a non-causal ragged
# case); the dense decode (#3) at group 1 over its 8-slot, 512-row serving
# cache, at the serving lengths and the 64-key tile edges
HYB_H, HYB_HD = 32, 80
FLASH_HD80_CASES = (  # (B, H, Sq, Sk, causal, hd)
    (TRAIN_B, HYB_H, TRAIN_S, TRAIN_S, True, HYB_HD),
    (1, HYB_H, 200, 200, True, HYB_HD),
    (2, 4, 130, 200, False, HYB_HD),
)
#: zamba2 parity depth: 2 cycles of 6 Mamba2 layers, so the shared block runs twice
HYBRID_PARITY_LAYERS = 12
# the audio / VLM slice's attention: musicgen-large's 32 MHA heads of 64 (GQA
# group 1) and pixtral-12b's 32 heads over 8 kv heads of 128 (group 4), over
# the serving pool (8 slots, 16-token pages, 32 columns); flash at
# musicgen's training shape, a ragged causal case and a monolithic bucket
MG_H, MG_HD = 32, 64
PX_H, PX_KVH = 32, 8
FLASH_HD64_CASES = (  # (B, H, Sq, Sk, causal, hd)
    (TRAIN_B, MG_H, TRAIN_S, TRAIN_S, True, MG_HD),
    (2, MG_H, 1000, 1000, True, MG_HD),
    (1, MG_H, 200, 200, True, MG_HD),
)
#: audio / VLM parity depth (full width)
AV_PARITY_LAYERS = 2
#: olmo-1b's attention: 16 MHA heads of 128 (GQA group 1)
OLMO_H = 16
#: pixtral-12b's training depth: 8 of 40 layers at full width (3.52 B
#: parameters, 56 GB of fp32 params, gradients and AdamW moments; full depth
#: would need 196 GB)
PIXTRAL_TRAIN_LAYERS = 8


#: the runs whose launches the audio / VLM slice's kernel rows report
SLICE_ROW_RUNS = {"_hd64": ("musicgen_train", "musicgen_serve", "musicgen_spec_serve"),
                  "_g4": ("pixtral_serve", "pixtral_dense"),
                  "_g1": ("olmo_serve", "olmo_collocate")}
#: the kernels each path runs
SERVE_KERNELS = ("paged_decode_attention", "paged_prefill_attention")
TRAIN_KERNELS = ("flash_attention_fwd", "flash_attention_bwd")
SPEC_KERNELS = ("decode_attention", "prefill_attention", "paged_verify_attention",
                "paged_tree_verify_attention")
DENSE_TARGET_KERNELS = ("decode_attention", "prefill_attention", "verify_attention",
                        "tree_verify_attention")
SSM_KERNELS = ("ssm_scan",)
HYBRID_SERVE_KERNELS = ("flash_attention_fwd", "decode_attention")


def log(msg: str) -> None:
    print(f"[smoke] {msg}", flush=True)


def _card() -> str:
    """``nvidia-smi``'s name and power limit of the card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def _require_launches(phase, counts, kernels):
    """Every kernel of the path launched in the phase's run, and no plain
    version ran in it."""
    for name, c in counts.items():
        if c["torch"] != 0 or (name in kernels and c["cuda"] <= 0):
            raise AssertionError(f"{phase}: {name} launches {c} (each of {kernels} "
                                 f"must launch, no plain version may run)")


def _require_tc_bodies(phase, counts):
    """Every launch of a body-counted kernel (the chunked prefill, the verify
    and the tree verify, each paged and dense) in the phase's bf16 run
    took the tensor-core body (``ops.body_counts``, read with ``counts``).
    Returns the body counts for the phase's log line."""
    from repro_torch.kernels import ops

    bodies = ops.body_counts()
    for name, by in bodies.items():
        if by["fma"] != 0 or by["tc"] != counts[name]["cuda"]:
            raise AssertionError(f"{phase}: {name} bodies {by} for {counts[name]['cuda']} "
                                 f"launches (bf16 at hd 128 must take the tensor-core body)")
    return bodies


# ---------------------------------------------------------------------------
# 1. device
# ---------------------------------------------------------------------------


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("[smoke] FAIL: no CUDA device (torch.cuda.is_available() is False)")
    print(_card(), flush=True)
    log(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ---------------------------------------------------------------------------
# 2. build
# ---------------------------------------------------------------------------


def phase_build():
    """Builds every kernel library; returns ``{name: compiler output}``
    (``ptxas -v`` included) for the libraries it built."""
    from repro_torch.kernels import build

    t0 = time.monotonic()
    built = build.build()
    for name, (secs, out) in built.items():
        usage = [ln.strip() for ln in out.splitlines() if "registers" in ln or "spill" in ln]
        log(f"build {name}: {secs:.1f}s; ptxas: {' | '.join(usage)}")
    log(f"build: {len(built)} libraries in {time.monotonic() - t0:.1f}s "
        f"into {build.BUILD_DIR}")
    return {name: out for name, (_, out) in built.items()}


# ---------------------------------------------------------------------------
# 3. kernels
# ---------------------------------------------------------------------------


def _time_ms(fn, reps: int = 30) -> float:
    """Median device time of ``fn`` over ``reps`` launches, each after a
    1 GiB write that evicts the 50 MB L2 and keeps the card busy (~0.3 ms)
    while the host enqueues the timed launch, so host-side wrapper work does
    not show up as device time."""
    import torch

    flush = torch.empty(1 << 30, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def _pool_inputs(dtype, seed: int = 0, hd: int = HD, kvh: int = KVH, ncols: int = NCOLS):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    pool_n = 1 + B * ncols
    k_pool = torch.randn((pool_n, PAGE, kvh, hd), generator=g, device="cuda").to(dtype)
    v_pool = torch.randn((pool_n, PAGE, kvh, hd), generator=g, device="cuda").to(dtype)
    perm = torch.randperm(pool_n - 1, generator=g, device="cuda") + 1
    bt = perm.reshape(B, ncols).to(torch.int32)
    bt[1, :SHARED_PAGES] = bt[0, :SHARED_PAGES]
    bt = torch.cat([bt, torch.zeros((B, 1), dtype=torch.int32, device="cuda")], 1)
    return g, k_pool, v_pool, bt.contiguous()


def _bound_ms(nbytes: float, flops: float, dtype) -> tuple[float, str]:
    import torch

    peak = PEAK_FLOPS_BF16 if dtype == torch.bfloat16 else PEAK_FLOPS_FP32
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def _cost_bound(name, *args) -> tuple[float, str]:
    """``_bound_ms`` of ``kernels.cost.<name>(*args)``: the bytes and
    operations the kernel's function needs on these inputs."""
    from repro_torch.kernels import cost

    c = getattr(cost, name)(*args)
    return _bound_ms(c.bytes, c.flops, c.dtype)


def _prefill_cases(dense=False):
    """(label, keyword arguments of a prefill ``make_inputs`` factory): the
    chunked-prefill kernels' extra check shapes -- GQA group 7 (H = 56 over
    kvH = 8: 224 rows, 3.5 tiles of 64), hd 64, and C = 64 (two q tiles at
    group 2; on the dense cache two chunks also run past S)."""
    import torch

    def i32(xs):
        return torch.tensor(xs, dtype=torch.int32, device="cuda")

    c64_starts = PREFILL_STARTS_C64_DENSE if dense else PREFILL_STARTS_C64
    return (("", {}), (" (group 7, H=56)", {"h": 56}), (" (hd 64)", {"hd": 64}),
            (" (C=64)", {"c": 64, "st": i32(c64_starts), "cl": i32(PREFILL_LENS_C64)}))


def _check_kernel(name, kernel, plain, make_inputs):
    """The kernel against its plain version on the same inputs, in bf16 (the
    plain version computing in fp32) and in fp32; returns the errors."""
    import torch

    errs = {}
    for dtype, tol in ((torch.bfloat16, BF16_ATOL), (torch.float32, FP32_ATOL)):
        args = make_inputs(dtype)
        out = kernel(*args)
        torch.cuda.synchronize()
        ref = plain(*[a.float() if a.is_floating_point() else a for a in args])
        if out.shape != ref.shape:
            raise AssertionError(f"{name}: shape {tuple(out.shape)} != {tuple(ref.shape)}")
        if not torch.isfinite(out).all():
            raise AssertionError(f"{name} {dtype}: non-finite output")
        err = (out.float() - ref).abs().max().item()
        errs[str(dtype).split(".")[-1]] = err
        log(f"kernel {name} {dtype}: max_abs_err {err:.3e} (tol {tol:g})")
        if not err <= tol:
            raise AssertionError(f"{name} {dtype}: max_abs_err {err} > {tol}")
    return errs


def _decode_cases(edge_lengths, long_kw):
    """(label, keyword arguments of a decode ``make_inputs`` factory): the
    serving shape (group 2, hd 128), lengths at the 64-key tile edges,
    groups 1 and 7 at hd 128 and 64, hd 64, and a 4,096-key slot."""
    return (("", {}), (" (tile edges)", {"lens": edge_lengths}),
            (" (group 1, H=8)", {"h": 8}), (" (group 1, hd 64)", {"h": 8, "hd": 64}),
            (" (group 7, H=56)", {"h": 56}),
            (" (group 7, hd 64)", {"h": 28, "kvh": 4, "hd": 64}),
            (" (hd 64)", {"hd": 64}), (" (4,096 keys)", long_kw))


def _check_decode(name, kernel, plain, make_inputs):
    """``_check_kernel``, and the rows of a slot with ``lengths <= 0`` exactly
    zero in both types."""
    import torch

    errs = _check_kernel(name, kernel, plain, make_inputs)
    for dtype in (torch.bfloat16, torch.float32):
        args = make_inputs(dtype)
        out = kernel(*args)
        if out[args[-1] <= 0].any():
            raise AssertionError(f"{name} {dtype}: a slot with lengths <= 0 is not zeros")
    return errs


def _check_nan_slot(name, kernel, plain, make_inputs, poison, slot):
    """A NaN at one live K position of ``slot`` (``poison(args)`` returns the
    arguments with a poisoned copy of K), in bf16 and fp32: the kernel's
    output is non-finite exactly where the plain version's is (and somewhere
    in ``slot``: the NaN is not swallowed), and every other slot's output is
    bit-equal to the same call without the NaN."""
    import torch

    for dtype in (torch.bfloat16, torch.float32):
        args = make_inputs(dtype)
        clean = kernel(*args)
        pargs = poison(args)
        out = kernel(*pargs)
        ref = plain(*[a.float() if a.is_floating_point() else a for a in pargs])
        bad, ref_bad = ~torch.isfinite(out), ~torch.isfinite(ref)
        others = [i for i in range(out.shape[0]) if i != slot]
        if not bad[slot].any():
            raise AssertionError(f"{name} {dtype}: the NaN in slot {slot} was swallowed")
        if not torch.equal(bad, ref_bad):
            raise AssertionError(f"{name} {dtype}: non-finite at {int(bad.sum())} places, "
                                 f"the plain version at {int(ref_bad.sum())}, not the same")
        if not torch.equal(out[others], clean[others]):
            raise AssertionError(f"{name} {dtype}: a NaN in slot {slot} changed other slots")
        log(f"kernel {name} {dtype}: NaN in slot {slot} -> {int(bad.sum())} non-finite "
            f"outputs, where the plain version's are; other slots bit-equal")


def _nan_checks():
    """Every attention kernel propagates a NaN key as its plain version does
    (``_check_nan_slot``): the paged and dense decode, chunked prefill, verify
    and tree verify at their serving shapes with the NaN in a position every
    query row of the slot sees, and flash forward (causal: the rows at and
    past the NaN) and forward + backward (non-causal: every row)."""
    import torch

    from repro_torch.kernels import decode_attention as dd
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_decode_attention as pdec
    from repro_torch.kernels import paged_prefill_attention as ppre
    from repro_torch.kernels import paged_tree_verify_attention as ptv
    from repro_torch.kernels import paged_verify_attention as pv
    from repro_torch.kernels import prefill_attention as dp
    from repro_torch.kernels import tree_verify_attention as tv
    from repro_torch.kernels import verify_attention as va
    from repro_torch.spec.tree import branching_tree, tree_ancestor_masks

    def i32(xs):
        return torch.tensor(xs, dtype=torch.int32, device="cuda")

    def paged(q_shape, *extra):
        def make(dtype):
            g, k_pool, v_pool, bt = _pool_inputs(dtype, seed=7)
            q = torch.randn((B, *q_shape), generator=g, device="cuda").to(dtype)
            return (q, k_pool, v_pool, bt, *extra)
        return make

    def dense(q_shape, *extra):
        def make(dtype):
            g, k, v = _dense_inputs(dtype, seed=7)
            q = torch.randn((B, *q_shape), generator=g, device="cuda").to(dtype)
            return (q, k, v, *extra)
        return make

    tree = branching_tree(2, 2)
    anc = torch.tensor(tree_ancestor_masks(tree), device="cuda").expand(B, len(tree)).contiguous()
    # the poisoned slot: dense decode and both prefills slot 2 (length 300,
    # start 100), paged decode and the verify pairs slot 1 (length 300; its
    # pages past the first 64 keys are its own)
    dlen, plen = i32(DENSE_LENGTHS), i32(DECODE_LENGTHS)
    st, cl, vl = i32(PREFILL_STARTS), i32(PREFILL_LENS), i32(VERIFY_LENGTHS)
    cases = (
        ("paged_decode_attention", pdec.paged_decode_attention,
         pdec.paged_decode_attention_torch, paged((H, HD), plen), _poison_paged(1, 100), 1),
        ("paged_prefill_attention", ppre.paged_prefill_attention,
         ppre.paged_prefill_attention_torch, paged((CHUNK, H, HD), st, cl),
         _poison_paged(2, 50), 2),
        ("decode_attention", dd.decode_attention, dd.decode_attention_torch,
         dense((H, HD), dlen), _poison_dense(2, 100), 2),
        ("prefill_attention", dp.prefill_attention, dp.prefill_attention_torch,
         dense((CHUNK, H, HD), st, cl), _poison_dense(2, 50), 2),
        ("paged_verify_attention", pv.paged_verify_attention, pv.paged_verify_attention_torch,
         paged((5, H, HD), vl), _poison_paged(1, 100), 1),
        ("paged_tree_verify_attention", ptv.paged_tree_verify_attention,
         ptv.paged_tree_verify_attention_torch, paged((len(tree), H, HD), vl, anc),
         _poison_paged(1, 100), 1),
        ("verify_attention", va.verify_attention, va.verify_attention_torch,
         dense((5, H, HD), vl), _poison_dense(1, 100), 1),
        ("tree_verify_attention", tv.tree_verify_attention, tv.tree_verify_attention_torch,
         dense((len(tree), H, HD), vl, anc), _poison_dense(1, 100), 1),
    )
    for name, kernel, plain, make, poison, slot in cases:
        _check_nan_slot(name, kernel, plain, make, poison, slot)
    _flash_nan_checks(HD)


def _flash_nan_checks(hd):
    """``_check_nan_slot`` for the flash kernels at head dim ``hd``."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    # flash: [B, H, S, hd]; causal forward with the NaN at key 100 of batch 1,
    # head 2 (rows >= 100 of that head see it), then non-causal forward and
    # backward (every row of the head sees it; the plain version's autograd
    # spreads 0 * NaN through masked entries, so a causal backward's dQ rows
    # before the NaN differ by construction, not by the kernel)
    def flash_make(dtype):
        q, k, v, do = _flash_inputs(dtype, 2, 4, 256, 256, hd=hd, seed=8)
        return q, k, v, do

    def flash_poison(args):
        k = args[1].clone()
        k[1, 2, 100, 5] = float("nan")
        return (args[0], k, *args[2:])

    for causal in (True, False):
        def fwd(q, k, v, do, causal=causal):
            return fa.flash_attention_fwd(q, k, v, causal=causal)[0]

        def fwd_plain(q, k, v, do, causal=causal):
            return fa.flash_attention_torch(q, k, v, causal=causal)

        _check_nan_slot(f"flash_attention forward (causal={causal}, hd {hd})", fwd,
                        fwd_plain, flash_make, flash_poison, 1)

    def bwd(q, k, v, do):
        out, lse = fa.flash_attention_fwd(q, k, v, causal=False)
        return torch.stack(fa.flash_attention_bwd(q, k, v, out, do, lse, causal=False), 1)

    def bwd_plain(q, k, v, do):
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        ref = fa.flash_attention_torch(*leaves, causal=False)
        return torch.stack(torch.autograd.grad(ref, leaves, do), 1)

    _check_nan_slot(f"flash_attention backward (dq, dk, dv; causal=False, hd {hd})", bwd,
                    bwd_plain, flash_make, flash_poison, 1)


def _one_tile_per_cta_ms(fn):
    """``fn``'s time with the decode kernels' plan at one 64-key tile a CTA
    (the default is DECODE_TILES_PER_CTA)."""
    from repro_torch.kernels import decode_attention as dd

    default, dd.DECODE_TILES_PER_CTA = dd.DECODE_TILES_PER_CTA, 1
    try:
        return _time_ms(fn)
    finally:
        dd.DECODE_TILES_PER_CTA = default


def phase_kernels(build_logs):
    """Returns the kernel rows of the final ``kernels`` line (launches are
    filled in by the serve phase); ``build_logs``: phase 2's compiler
    output by library."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import paged_decode_attention as dec
    from repro_torch.kernels import paged_prefill_attention as pre

    rows = []

    # ---- paged decode (#1): the serving shape, then the shapes the cluster
    # kernel must also take -------------------------------------------------
    lengths = torch.tensor(DECODE_LENGTHS, dtype=torch.int32, device="cuda")
    long_lengths = torch.tensor(LONG_LENGTHS, dtype=torch.int32, device="cuda")

    def decode_inputs(h=H, kvh=KVH, hd=HD, ncols=NCOLS, lens=lengths):
        def make(dtype):
            g, k_pool, v_pool, bt = _pool_inputs(dtype, hd=hd, kvh=kvh, ncols=ncols)
            q = torch.randn((B, h, hd), generator=g, device="cuda").to(dtype)
            return q, k_pool, v_pool, bt, lens
        return make

    errs = _worst(*[
        _check_decode(f"paged_decode_attention{label}", dec.paged_decode_attention,
                      dec.paged_decode_attention_torch, decode_inputs(**kw))
        for label, kw in _decode_cases(
            torch.tensor(DECODE_EDGE_LENGTHS, dtype=torch.int32, device="cuda"),
            {"ncols": LONG_NCOLS, "lens": long_lengths}) + (GROUP6_CASE,)])
    g6 = decode_inputs(**GROUP6_CASE[1])(torch.bfloat16)
    g6_ms = _time_ms(lambda: dec.paged_decode_attention(*g6))
    g6_p_ms = _time_ms(lambda: dec.paged_decode_attention_torch(*g6))
    del g6
    q, k_pool, v_pool, bt, _ = decode_inputs()(torch.bfloat16)
    k_ms = _time_ms(lambda: dec.paged_decode_attention(q, k_pool, v_pool, bt, lengths))
    p_ms = _time_ms(lambda: dec.paged_decode_attention_torch(q, k_pool, v_pool, bt, lengths))
    one_ms = _one_tile_per_cta_ms(lambda: dec.paged_decode_attention(q, k_pool, v_pool, bt,
                                                                    lengths))

    def paged_decode_yardsticks(q, k_pool, v_pool, bt, lens):
        """SDPA over the pre-gathered pages (gather not timed), and the bound."""
        s = (bt.shape[1] - 1) * PAGE
        kd = dec.gather_pages(k_pool, bt).transpose(1, 2).repeat_interleave(H // KVH, 1)
        vd = dec.gather_pages(v_pool, bt).transpose(1, 2).repeat_interleave(H // KVH, 1)
        mask = (torch.arange(s, device="cuda")[None, :] < lens[:, None])[:, None, None, :]
        l_ms = _time_ms(lambda: F.scaled_dot_product_attention(q[:, :, None], kd, vd,
                                                               attn_mask=mask))
        return (l_ms, *_cost_bound("paged_decode", q, k_pool, v_pool, bt, lens))

    l_ms, bound, by = paged_decode_yardsticks(q, k_pool, v_pool, bt, lengths)
    lq, lk, lv, lbt, _ = decode_inputs(ncols=LONG_NCOLS, lens=long_lengths)(torch.bfloat16)
    long_ms = _time_ms(lambda: dec.paged_decode_attention(lq, lk, lv, lbt, long_lengths))
    long_l_ms, long_bound, _ = paged_decode_yardsticks(lq, lk, lv, lbt, long_lengths)
    del lq, lk, lv, lbt
    rows.append({
        "name": "paged_decode_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_decode_attention.cu",
        "replaces": "src/repro/kernels/paged_decode_attention.py:53",
        "launches": 0, "max_abs_err": errs["bfloat16"],
        "max_abs_err_fp32": errs["float32"],
        "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound, "bound_by": by,
        "library_ms": l_ms, "ms_1_tile_per_cta": one_ms, "ms_4096_keys": long_ms,
        "library_ms_4096_keys": long_l_ms, "bound_ms_4096_keys": long_bound,
        "ms_group6": g6_ms, "plain_ms_group6": g6_p_ms,
    })
    log(f"kernel paged_decode_attention: {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
        f"sdpa {l_ms:.4f} ms, bound {bound:.4f} ms ({by}); at 1 tile a CTA {one_ms:.4f} ms; "
        f"4,096-key table {long_ms:.4f} ms, sdpa {long_l_ms:.4f} ms, bound {long_bound:.4f} ms; "
        f"group 6 (H=48) {g6_ms:.4f} ms, plain {g6_p_ms:.4f} ms")

    # ---- paged chunked prefill: the serving shape, then the shapes the
    # tensor-core body must also take (group 7, hd 64, two q tiles) ----------
    starts = torch.tensor(PREFILL_STARTS, dtype=torch.int32, device="cuda")
    clens = torch.tensor(PREFILL_LENS, dtype=torch.int32, device="cuda")

    def prefill_inputs(h=H, hd=HD, c=CHUNK, st=starts, cl=clens):
        def make(dtype):
            g, k_pool, v_pool, bt = _pool_inputs(dtype, seed=1, hd=hd)
            q = torch.randn((B, c, h, hd), generator=g, device="cuda").to(dtype)
            return q, k_pool, v_pool, bt, st, cl
        return make

    errs = _worst(*[
        _check_kernel(f"paged_prefill_attention{label}", pre.paged_prefill_attention,
                      pre.paged_prefill_attention_torch, prefill_inputs(**kw))
        for label, kw in _prefill_cases() + (GROUP6_CASE,)])
    g6 = prefill_inputs(**GROUP6_CASE[1])(torch.bfloat16)
    g6_ms = _time_ms(lambda: pre.paged_prefill_attention(*g6))
    g6_p_ms = _time_ms(lambda: pre.paged_prefill_attention_torch(*g6))
    del g6
    q, k_pool, v_pool, bt, _, _ = prefill_inputs()(torch.bfloat16)
    k_ms = _time_ms(lambda: pre.paged_prefill_attention(q, k_pool, v_pool, bt, starts, clens))
    p_ms = _time_ms(
        lambda: pre.paged_prefill_attention_torch(q, k_pool, v_pool, bt, starts, clens)
    )
    S = NCOLS * PAGE
    kd = dec.gather_pages(k_pool, bt).transpose(1, 2).repeat_interleave(H // KVH, 1)
    vd = dec.gather_pages(v_pool, bt).transpose(1, 2).repeat_interleave(H // KVH, 1)
    t = torch.arange(CHUNK, device="cuda")
    bound_pos = starts[:, None] + t[None, :]
    mask = (torch.arange(S, device="cuda")[None, None, :] <= bound_pos[:, :, None]) & (
        t[None, :, None] < clens[:, None, None])
    q4 = q.transpose(1, 2)
    l_ms = _time_ms(
        lambda: F.scaled_dot_product_attention(q4, kd, vd, attn_mask=mask[:, None])
    )
    bound, by = _cost_bound("paged_prefill", q, k_pool, v_pool, bt, starts, clens)
    # what paces the launch: the same chunks with every slot's prefix cut
    # to its first 64-key tile, and the longest slot alone
    zeros = torch.zeros_like(starts)
    longest = int(torch.argmax(starts + clens))
    alone = torch.where(torch.arange(B, device="cuda") == longest, clens, zeros)
    one_tile_ms = _time_ms(lambda: pre.paged_prefill_attention(q, k_pool, v_pool, bt, zeros,
                                                               clens))
    alone_ms = _time_ms(lambda: pre.paged_prefill_attention(q, k_pool, v_pool, bt, starts,
                                                            alone))
    rows.append({
        "name": "paged_prefill_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_prefill_attention.cu",
        "replaces": "src/repro/kernels/paged_prefill_attention.py:50",
        "launches": 0, "max_abs_err": errs["bfloat16"],
        "max_abs_err_fp32": errs["float32"],
        "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound, "bound_by": by,
        "library_ms": l_ms, "ms_one_tile_prefixes": one_tile_ms,
        "ms_longest_slot_alone": alone_ms, "ms_group6": g6_ms, "plain_ms_group6": g6_p_ms,
    })
    log(f"kernel paged_prefill_attention: {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
        f"sdpa {l_ms:.4f} ms, bound {bound:.4f} ms ({by}); every prefix cut to one "
        f"tile {one_tile_ms:.4f} ms, slot {longest} alone {alone_ms:.4f} ms; group 6 "
        f"(H=48) {g6_ms:.4f} ms, plain {g6_p_ms:.4f} ms")
    _nan_checks()
    flash = _flash_rows()
    _flash_long_rows()
    return (rows + flash + _spec_rows() + _dense_target_rows() + _ssm_rows()
            + _hd80_rows() + _slice_rows() + _ssm_bwd_rows(build_logs.get("ssm_scan", ""))
            + _olmo_rows() + _fp8_rows())


def _flash_inputs(dtype, b, h, sq, sk, hd=HD, seed=0):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((b, h, sq, hd), generator=g, device="cuda").to(dtype)
    k = torch.randn((b, h, sk, hd), generator=g, device="cuda").to(dtype)
    v = torch.randn((b, h, sk, hd), generator=g, device="cuda").to(dtype)
    do = torch.randn((b, h, sq, hd), generator=g, device="cuda").to(dtype)
    return q, k, v, do


def _check_flash(cases=FLASH_CASES):
    """Forward output and dQ / dK / dV of the kernels against the plain
    version (autograd, fp32, on the same inputs) for every case and dtype;
    returns the worst errors (forward absolute, gradients relative to the
    largest |g|) of the first (training-shape) case."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    worst = {}
    for case in cases:
        b, h, sq, sk, causal, hd = case
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, do = _flash_inputs(dtype, b, h, sq, sk, hd)
            out, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
            grads = fa.flash_attention_bwd(q, k, v, out, do, lse, causal=causal)
            torch.cuda.synchronize()
            leaves = [t.float().requires_grad_() for t in (q, k, v)]
            ref = fa.flash_attention_torch(*leaves, causal=causal)
            rgrads = torch.autograd.grad(ref, leaves, do.float())
            bf16 = dtype == torch.bfloat16
            fwd_tol = BF16_ATOL if bf16 else FP32_ATOL
            grad_tol = GRAD_RTOL_BF16 if bf16 else GRAD_RTOL_FP32
            if not (torch.isfinite(out).all() and all(torch.isfinite(g).all() for g in grads)):
                raise AssertionError(f"flash_attention {case} {dtype}: non-finite output")
            fwd_err = (out.float() - ref).abs().max().item()
            grad_err = max(((g.float() - r).abs().max() / r.abs().max()).item()
                           for g, r in zip(grads, rgrads))
            log(f"kernel flash_attention {case} {dtype}: forward max_abs_err "
                f"{fwd_err:.3e} (tol {fwd_tol:g}); dq/dk/dv max err / max|g| "
                f"{grad_err:.3e} (tol {grad_tol:g})")
            if not (fwd_err <= fwd_tol and grad_err <= grad_tol):
                raise AssertionError(f"flash_attention {case} {dtype}: forward err "
                                     f"{fwd_err}, gradient err {grad_err}")
            if case == cases[0]:
                name = "bfloat16" if bf16 else "float32"
                worst[name] = (fwd_err, grad_err)
    return worst


def _flash_rows(cases=FLASH_CASES, suffix=""):
    """Rows of flash attention forward and backward (names + ``suffix``):
    checked at every case of ``cases``, timed at the first (the training
    shape) in bf16; the bound and TFLOP/s count the real head dim's work."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import cost as kcost
    from repro_torch.kernels import flash_attention as fa

    errs = _check_flash(cases)
    b, h, s, _, _, hd = cases[0]
    q, k, v, do = _flash_inputs(torch.bfloat16, b, h, s, s, hd=hd, seed=1)
    out, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    fwd_ms = _time_ms(lambda: fa.flash_attention_fwd(q, k, v, causal=True))
    bwd_ms = _time_ms(lambda: fa.flash_attention_bwd(q, k, v, out, do, lse, causal=True))
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    plain_out = fa.flash_attention_torch(*leaves, causal=True)
    plain_fwd_ms = _time_ms(lambda: fa.flash_attention_torch(q, k, v, causal=True))
    plain_bwd_ms = _time_ms(
        lambda: torch.autograd.grad(plain_out, leaves, do, retain_graph=True))
    # yardstick: SDPA on the same bf16 inputs (forward; backward alone)
    sdpa_out = F.scaled_dot_product_attention(*leaves, is_causal=True)
    sdpa_fwd_ms = _time_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True))
    sdpa_bwd_ms = _time_ms(
        lambda: torch.autograd.grad(sdpa_out, leaves, do, retain_graph=True))
    del plain_out, sdpa_out
    # bounds: each input read once, each output written once; the causal
    # (q, k) pairs this shape has, 2 products forward and 5 backward
    fwd_flops = kcost.flash_fwd(q, k, v, True).flops
    bwd_flops = kcost.flash_bwd(q, k, v, True).flops
    fwd_bound, fwd_by = _cost_bound("flash_fwd", q, k, v, True)
    bwd_bound, bwd_by = _cost_bound("flash_bwd", q, k, v, True)
    src = "src/repro_torch/kernels/csrc/flash_attention.cu"
    rows = []
    for name, ms, plain_ms, lib_ms, bound, by, flops, i in (
        ("flash_attention_fwd", fwd_ms, plain_fwd_ms, sdpa_fwd_ms, fwd_bound, fwd_by,
         fwd_flops, 0),
        ("flash_attention_bwd", bwd_ms, plain_bwd_ms, sdpa_bwd_ms, bwd_bound, bwd_by,
         bwd_flops, 1),
    ):
        tflops = flops / (ms * 1e-3) / 1e12
        rows.append({
            "name": name + suffix, "route": "cuda", "source": src,
            "replaces": "src/repro/kernels/flash_attention.py:92",
            "launches": 0, "max_abs_err": errs["bfloat16"][i],
            "max_abs_err_fp32": errs["float32"][i],
            "err_kind": "absolute" if i == 0 else "relative to max|g|",
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": lib_ms, "tflops": tflops, "bound_share": bound / ms,
        })
        log(f"kernel {name} (B={b}, H={h}, S={s}, hd={hd}, causal, bf16): {ms:.4f} ms "
            f"= {tflops:.1f} TFLOP/s, {100 * bound / ms:.1f}% of the bound {bound:.4f} ms "
            f"({by}); plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms "
            f"({ms / lib_ms:.2f}x sdpa's time)")
    log(f"sdpa forward+backward {sdpa_fwd_ms + sdpa_bwd_ms:.4f} ms; flash kernels "
        f"forward+backward {fwd_ms + bwd_ms:.4f} ms (hd {hd})")
    return rows


def _flash_long_rows():
    """The same kernels and SDPA at one long sequence (B=1, H=16, S=4096,
    causal, bf16), where each CTA walks many more tiles: separates the
    kernels' per-tile rate from the fixed cost of each CTA."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    b, h, s = 1, H, 4 * TRAIN_S
    q, k, v, do = _flash_inputs(torch.bfloat16, b, h, s, s, seed=2)
    out, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    sdpa_out = F.scaled_dot_product_attention(*leaves, is_causal=True)
    times = {
        "forward": (_time_ms(lambda: fa.flash_attention_fwd(q, k, v, causal=True)),
                    _time_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True)),
                    4),
        "backward": (_time_ms(lambda: fa.flash_attention_bwd(q, k, v, out, do, lse,
                                                             causal=True)),
                     _time_ms(lambda: torch.autograd.grad(sdpa_out, leaves, do,
                                                          retain_graph=True)),
                     10),
    }
    pairs = b * h * s * (s + 1) // 2
    log(f"flash attention at B={b}, H={h}, S={s}, causal, bf16: " + "; ".join(
        f"{name} {ms:.4f} ms = {per_pair * pairs * HD / (ms * 1e-3) / 1e12:.1f} TFLOP/s "
        f"(sdpa {lib:.4f} ms = {per_pair * pairs * HD / (lib * 1e-3) / 1e12:.1f})"
        for name, (ms, lib, per_pair) in times.items()))


def _flash_bwd_by_kernel(row):
    """The flash backward's three kernels one by one at the training shape
    (bf16), from ``torch.profiler`` with the L2 flushed before each call:
    delta reads O and dO and writes D; dkdv runs 4 products, dq 3 (it
    recomputes S and dP).  Runs after every other phase, since a profiler
    session leaves each later launch slower on the host."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    b, h, s = TRAIN_B, H, TRAIN_S
    q, k, v, do = _flash_inputs(torch.bfloat16, b, h, s, s, seed=1)
    out, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    parts = _kernel_ms_by_name(
        lambda: fa.flash_attention_bwd(q, k, v, out, do, lse, causal=True),
        ("flash_bwd_delta", "flash_bwd_dkdv", "flash_bwd_dq"))
    elems, pairs = b * h * s * HD, b * h * s * (s + 1) // 2
    work = {"flash_bwd_delta": ("GB/s", (4 * elems + b * h * s * 4) / 1e9),
            "flash_bwd_dkdv": ("TFLOP/s", 8 * pairs * HD / 1e12),
            "flash_bwd_dq": ("TFLOP/s", 6 * pairs * HD / 1e12)}
    row["kernels_ms"] = parts
    log("kernel flash_attention_bwd by kernel (median of 30, profiler): " + ", ".join(
        f"{n.split('_')[-1]} {t:.4f} ms = {work[n][1] / (t * 1e-3):.1f} {work[n][0]}"
        if t is not None else f"{n.split('_')[-1]} not measured" for n, t in parts.items()))


def _kernel_ms_by_name(fn, names, reps: int = 30) -> dict:
    """Median device time of the kernels whose names contain each of
    ``names``, over ``reps`` calls of ``fn`` each after the L2-flushing
    write of ``_time_ms``, read from ``torch.profiler``; None where the
    profiler saw none."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    flush = torch.empty(1 << 30, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    times = {n: [] for n in names}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            for n in names:
                if n in e.name:
                    times[n].append((e.time_range.end - e.time_range.start) / 1e3)
    return {n: sorted(t)[len(t) // 2] if t else None for n, t in times.items()}


def _dense_inputs(dtype, seed, hd=HD, kvh=KVH, s=DENSE_S):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    k = torch.randn((B, s, kvh, hd), generator=g, device="cuda").to(dtype)
    v = torch.randn((B, s, kvh, hd), generator=g, device="cuda").to(dtype)
    return g, k, v


def _row(name, src, replaces, errs, k_ms, p_ms, l_ms, bound, by):
    log(f"kernel {name}: {k_ms:.4f} ms, plain {p_ms:.4f} ms, sdpa {l_ms:.4f} ms, "
        f"bound {bound:.4f} ms ({by})")
    return {
        "name": name, "route": "cuda", "source": f"src/repro_torch/kernels/csrc/{src}",
        "replaces": replaces, "launches": 0, "max_abs_err": errs["bfloat16"],
        "max_abs_err_fp32": errs["float32"], "ms": k_ms, "plain_ms": p_ms,
        "bound_ms": bound, "bound_by": by, "library_ms": l_ms,
    }


def _worst(*errs):
    return {k: max(e[k] for e in errs) for k in errs[0]}


def _spec_rows():
    """Rows of the speculative slice's kernels: the dense decode / chunked
    prefill (the draft model's) and the paged verify / tree verify (the
    target's), each checked at its path's shapes in bf16 and fp32 and timed
    in bf16 at the largest shape the path gives it."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as dd
    from repro_torch.kernels import paged_decode_attention as pdec
    from repro_torch.kernels import paged_tree_verify_attention as ptv
    from repro_torch.kernels import paged_verify_attention as pv
    from repro_torch.kernels import prefill_attention as dp
    from repro_torch.spec.tree import branching_tree, linear_chain, tree_ancestor_masks

    rows = []

    # ---- dense decode (#3): the draft's proposal step (H = 8) and, on the
    # dense target layout, the target's decode step (H = 16), plus the shapes
    # the cluster kernel must also take ------------------------------------------
    lengths = torch.tensor(DENSE_LENGTHS, dtype=torch.int32, device="cuda")
    long_lengths = torch.tensor(LONG_LENGTHS, dtype=torch.int32, device="cuda")

    def decode_inputs(h=DRAFT_H, kvh=KVH, hd=HD, s=DENSE_S, lens=lengths):
        def make(dtype):
            g, k, v = _dense_inputs(dtype, seed=2, hd=hd, kvh=kvh, s=s)
            q = torch.randn((B, h, hd), generator=g, device="cuda").to(dtype)
            return q, k, v, lens
        return make

    cases = [("", {}), (" (dense target, H=16)", {"h": H})] + [
        (label, {"h": H, **kw}) for label, kw in _decode_cases(
            torch.tensor(DENSE_EDGE_LENGTHS, dtype=torch.int32, device="cuda"),
            {"s": LONG_S, "lens": long_lengths})[1:]
        if "group 1" not in label] + [(" (group 1, hd 64)", {"hd": 64})]
    errs = _worst(*[_check_decode(f"decode_attention{label}", dd.decode_attention,
                                  dd.decode_attention_torch, decode_inputs(**kw))
                    for label, kw in cases])

    def dense_decode_times(h, s=DENSE_S, lens=lengths, plain=True):
        """(kernel, plain, SDPA, bound ms, bound by) in bf16 at h q heads."""
        q, k, v, _ = decode_inputs(h=h, s=s, lens=lens)(torch.bfloat16)
        k_ms = _time_ms(lambda: dd.decode_attention(q, k, v, lens))
        p_ms = _time_ms(lambda: dd.decode_attention_torch(q, k, v, lens)) if plain else None
        kt = k.transpose(1, 2).repeat_interleave(h // KVH, 1)
        vt = v.transpose(1, 2).repeat_interleave(h // KVH, 1)
        mask = (torch.arange(s, device="cuda")[None, :] < lens[:, None])[:, None, None, :]
        l_ms = _time_ms(lambda: F.scaled_dot_product_attention(q[:, :, None], kt, vt,
                                                               attn_mask=mask))
        return (k_ms, p_ms, l_ms, *_cost_bound("decode", q, k, v, lens))

    row = _row("decode_attention", "decode_attention.cu",
               "src/repro/kernels/decode_attention.py:92", errs, *dense_decode_times(DRAFT_H))
    k_ms, p_ms, l_ms, bound, by = dense_decode_times(H)
    log(f"kernel decode_attention (dense target, H={H}): {k_ms:.4f} ms, plain "
        f"{p_ms:.4f} ms, sdpa {l_ms:.4f} ms, bound {bound:.4f} ms ({by})")
    row.update(ms_target=k_ms, plain_ms_target=p_ms, library_ms_target=l_ms,
               bound_ms_target=bound)
    q, k, v, _ = decode_inputs()(torch.bfloat16)
    one_ms = _one_tile_per_cta_ms(lambda: dd.decode_attention(q, k, v, lengths))
    long_ms, _, long_l_ms, long_bound, _ = dense_decode_times(DRAFT_H, LONG_S, long_lengths,
                                                              plain=False)
    row.update(ms_1_tile_per_cta=one_ms, ms_4096_keys=long_ms,
               library_ms_4096_keys=long_l_ms, bound_ms_4096_keys=long_bound)
    log(f"kernel decode_attention: at 1 tile a CTA {one_ms:.4f} ms; S = {LONG_S} "
        f"{long_ms:.4f} ms, sdpa {long_l_ms:.4f} ms, bound {long_bound:.4f} ms")
    rows.append(row)

    # ---- dense chunked prefill (#4): the draft's chunk wave (H = 8) and, on
    # the dense target layout, the target's (H = 16), plus the shapes the
    # tensor-core body must also take -----------------------------------------
    starts = torch.tensor(PREFILL_STARTS, dtype=torch.int32, device="cuda")
    clens = torch.tensor(PREFILL_LENS, dtype=torch.int32, device="cuda")

    def prefill_inputs(h=DRAFT_H, hd=HD, c=CHUNK, st=starts, cl=clens):
        def make(dtype):
            g, k, v = _dense_inputs(dtype, seed=3, hd=hd)
            q = torch.randn((B, c, h, hd), generator=g, device="cuda").to(dtype)
            return q, k, v, st, cl
        return make

    cases = [("", {}), (" (dense target, H=16)", {"h": H})] + [
        (label, {"h": H, **kw}) for label, kw in _prefill_cases(dense=True)[1:]]
    errs = _worst(*[_check_kernel(f"prefill_attention{label}", dp.prefill_attention,
                                  dp.prefill_attention_torch, prefill_inputs(**kw))
                    for label, kw in cases])
    t = torch.arange(CHUNK, device="cuda")
    kpos = torch.arange(DENSE_S, device="cuda")
    mask = (kpos[None, None, :] <= (starts[:, None] + t[None, :])[:, :, None]) & (
        t[None, :, None] < clens[:, None, None])
    timed = {}
    for h in (DRAFT_H, H):  # the draft's heads, then the dense target's
        q, k, v, _, _ = prefill_inputs(h=h)(torch.bfloat16)
        k_ms = _time_ms(lambda: dp.prefill_attention(q, k, v, starts, clens))
        p_ms = _time_ms(lambda: dp.prefill_attention_torch(q, k, v, starts, clens))
        qt = q.transpose(1, 2)
        kt = k.transpose(1, 2).repeat_interleave(h // KVH, 1)
        vt = v.transpose(1, 2).repeat_interleave(h // KVH, 1)
        l_ms = _time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                               attn_mask=mask[:, None]))
        timed[h] = (k_ms, p_ms, l_ms, *_cost_bound("prefill", q, k, v, starts, clens))
    row = _row("prefill_attention", "prefill_attention.cu",
               "src/repro/kernels/prefill_attention.py:144", errs, *timed[DRAFT_H])
    k_ms, p_ms, l_ms, bound, by = timed[H]
    log(f"kernel prefill_attention (dense target, H={H}): {k_ms:.4f} ms, plain "
        f"{p_ms:.4f} ms, sdpa {l_ms:.4f} ms, bound {bound:.4f} ms ({by})")
    row.update(ms_target=k_ms, plain_ms_target=p_ms, library_ms_target=l_ms,
               bound_ms_target=bound)
    rows.append(row)

    # ---- paged verify (#7) and tree verify (#9): the target's verify pass,
    # bf16 on the tensor-core body, fp32 on the FMA body; also at qwen2-7b's
    # GQA group 7 (28 / 4 heads) and hd 64, where a suffix bucket (T = 64:
    # 448 rows) and the 31-node tree (217 rows) take several 64-row q tiles,
    # and at moonshot-v1-16b-a3b's group 1 (16 / 16 heads: 5- and 31-row
    # tiles) ---------------------------------------------------------------
    vlens = torch.tensor(VERIFY_LENGTHS, dtype=torch.int32, device="cuda")
    cap = NCOLS * PAGE

    def verify_inputs(t, anc=None, lens=vlens, h=H, kvh=KVH, hd=HD):
        def make(dtype):
            g, k_pool, v_pool, bt = _pool_inputs(dtype, seed=4, hd=hd, kvh=kvh)
            q = torch.randn((B, t, h, hd), generator=g, device="cuda").to(dtype)
            args = (q, k_pool, v_pool, bt, lens)
            return args if anc is None else args + (anc,)
        return make

    def anc_of(parents):
        n = len(parents)
        return torch.tensor(tree_ancestor_masks(parents), device="cuda").expand(
            B, n).contiguous()

    suffix = {t: torch.tensor(n, dtype=torch.int32, device="cuda")
              for t, n in SUFFIX_LENGTHS.items()}
    g7 = {"h": 28, "kvh": 4, "hd": 64}
    g1 = {"h": 16, "kvh": 16}  # moonshot-v1-16b-a3b: 16 / 16 heads of 128
    vcases = [(f"T={t}", t, {}) for t in VERIFY_TS]
    vcases += [(f"suffix prefill, T={t}", t, {"lens": n}) for t, n in suffix.items()]
    vcases += [("group 7, hd 64, T=5", 5, g7),
               ("group 7, hd 64, suffix prefill, T=64", 64, {**g7, "lens": suffix[64]}),
               ("group 1, T=5", 5, g1)]
    verr = [_check_kernel(f"paged_verify_attention ({label})", pv.paged_verify_attention,
                          pv.paged_verify_attention_torch, verify_inputs(t, **kw))
            for label, t, kw in vcases]
    trees = {"linear_chain(4)": linear_chain(4), "branching_tree(2, 2)": branching_tree(2, 2),
             "branching_tree(3, 10), 31 nodes": branching_tree(3, 10)}
    tcases = [(name, par, {}) for name, par in trees.items()]
    tcases += [(f"group {g}, {name}", trees[name], kw)
               for g, kw in (("7, hd 64", g7), ("1", g1))
               for name in ("linear_chain(4)", "branching_tree(3, 10), 31 nodes")]
    terr = [_check_kernel(f"paged_tree_verify_attention ({name})",
                          ptv.paged_tree_verify_attention,
                          ptv.paged_tree_verify_attention_torch,
                          verify_inputs(len(par), anc_of(par), **kw))
            for name, par, kw in tcases]
    chain = anc_of(linear_chain(4))
    for label, kw in (("", {}), (" (group 7, hd 64)", g7), (" (group 1)", g1)):
        for dtype in (torch.bfloat16, torch.float32):
            args = verify_inputs(5, **kw)(dtype)
            same = torch.equal(ptv.paged_tree_verify_attention(*args, chain),
                               pv.paged_verify_attention(*args))
            log(f"kernel paged_tree_verify_attention linear_chain(4) vs paged_verify_attention "
                f"T=5{label} {dtype}: bit-equal {same}")
            if not same:
                raise AssertionError("tree verify over a chain differs from verify")

    def verify_bound(q, *anc):
        return _cost_bound("paged_verify", q, k_pool, v_pool, bt, vlens, *anc)

    def one_tile_per_split_ms(fn):
        """``fn``'s time with the tensor-core body's split plan at one 64-key
        tile per split (the default is TC_TILES_PER_SPLIT)."""
        default, pv.TC_TILES_PER_SPLIT = pv.TC_TILES_PER_SPLIT, 1
        try:
            return _time_ms(fn)
        finally:
            pv.TC_TILES_PER_SPLIT = default

    def tree_seen(anc, n):
        """[B, n, cap]: node t sees kpos < lengths - n and the nodes of anc[:, t]."""
        kpos = torch.arange(cap, device="cuda")
        base = (vlens - n)[:, None, None]
        j = kpos[None, None, :] - base
        bits = (anc[:, :, None] >> j.clamp(0, 31)) & 1
        return (kpos < base) | ((j >= 0) & (j < n) & (bits == 1))

    q, k_pool, v_pool, bt, _ = verify_inputs(5)(torch.bfloat16)
    kd = pdec.gather_pages(k_pool, bt).transpose(1, 2).repeat_interleave(H // KVH, 1)
    vd = pdec.gather_pages(v_pool, bt).transpose(1, 2).repeat_interleave(H // KVH, 1)
    qt = q.transpose(1, 2)
    kpos = torch.arange(cap, device="cuda")
    t = torch.arange(5, device="cuda")
    vmask = kpos[None, None, :] <= (vlens[:, None] - 5 + t[None, :])[:, :, None]
    k_ms = _time_ms(lambda: pv.paged_verify_attention(q, k_pool, v_pool, bt, vlens))
    p_ms = _time_ms(lambda: pv.paged_verify_attention_torch(q, k_pool, v_pool, bt, vlens))
    l_ms = _time_ms(lambda: F.scaled_dot_product_attention(qt, kd, vd,
                                                           attn_mask=vmask[:, None]))
    bound, by = verify_bound(q)
    # what paces the launch: every slot cut to its first 64-key tile, and
    # the longest slot alone (the others empty)
    one_tile = vlens.clamp(max=64)
    longest = int(torch.argmax(vlens))
    alone = torch.where(torch.arange(B, device="cuda") == longest, vlens,
                        torch.zeros_like(vlens))
    one_tile_ms = _time_ms(lambda: pv.paged_verify_attention(q, k_pool, v_pool, bt, one_tile))
    alone_ms = _time_ms(lambda: pv.paged_verify_attention(q, k_pool, v_pool, bt, alone))
    split1_ms = one_tile_per_split_ms(
        lambda: pv.paged_verify_attention(q, k_pool, v_pool, bt, vlens))
    row = _row("paged_verify_attention", "paged_verify_attention.cu",
               "src/repro/kernels/paged_verify_attention.py:45", _worst(*verr),
               k_ms, p_ms, l_ms, bound, by)
    row.update(ms_one_tile_slots=one_tile_ms, ms_longest_slot_alone=alone_ms,
               ms_1_tile_per_split=split1_ms)
    log(f"kernel paged_verify_attention: every slot cut to one tile {one_tile_ms:.4f} ms, "
        f"slot {longest} alone {alone_ms:.4f} ms; at 1 tile per split {split1_ms:.4f} ms")
    rows.append(row)

    # the tree rows are timed at what the n-gram proposer sends: a chain of
    # gamma = 4 candidates (N = 5); and at the 31-node branching_tree(3, 10)
    tmask = tree_seen(chain, 5)
    k_ms = _time_ms(lambda: ptv.paged_tree_verify_attention(q, k_pool, v_pool, bt, vlens,
                                                            chain))
    p_ms = _time_ms(lambda: ptv.paged_tree_verify_attention_torch(q, k_pool, v_pool, bt,
                                                                  vlens, chain))
    l_ms = _time_ms(lambda: F.scaled_dot_product_attention(qt, kd, vd,
                                                           attn_mask=tmask[:, None]))
    bound, by = verify_bound(q, chain)
    row = _row("paged_tree_verify_attention", "paged_tree_verify_attention.cu",
               "src/repro/kernels/paged_tree_verify_attention.py:45", _worst(*terr),
               k_ms, p_ms, l_ms, bound, by)
    anc31 = anc_of(trees["branching_tree(3, 10), 31 nodes"])
    q31 = verify_inputs(31)(torch.bfloat16)[0]  # the same pool, 31 queries
    mask31 = tree_seen(anc31, 31)
    n31_ms = _time_ms(lambda: ptv.paged_tree_verify_attention(q31, k_pool, v_pool, bt, vlens,
                                                              anc31))
    l31_ms = _time_ms(lambda: F.scaled_dot_product_attention(
        q31.transpose(1, 2), kd, vd, attn_mask=mask31[:, None]))
    bound31, _ = verify_bound(q31, anc31)
    split1_ms = one_tile_per_split_ms(
        lambda: ptv.paged_tree_verify_attention(q, k_pool, v_pool, bt, vlens, chain))
    row.update(ms_31_nodes=n31_ms, library_ms_31_nodes=l31_ms, bound_ms_31_nodes=bound31,
               ms_1_tile_per_split=split1_ms)
    log(f"kernel paged_tree_verify_attention (31 nodes): {n31_ms:.4f} ms, sdpa "
        f"{l31_ms:.4f} ms, bound {bound31:.4f} ms; chain at 1 tile per split "
        f"{split1_ms:.4f} ms")
    rows.append(row)
    return rows


def _verify_by_kernel(rows):
    """The paged verify's and tree verify's two launches apart at the table's
    shape (bf16, T = 5 / the 5-node chain): the tensor-core split pass and
    ``combine_splits``; and the dense verify's and tree verify's one launch
    (the cluster kernel, whose span against the row's CUDA-event time shows
    what the launch costs outside the kernel).  From ``torch.profiler`` with
    the L2 flushed before each call.  Runs after every other phase, as
    ``_flash_bwd_by_kernel`` does."""
    import torch

    from repro_torch.kernels import paged_tree_verify_attention as ptv
    from repro_torch.kernels import paged_verify_attention as pv
    from repro_torch.kernels import tree_verify_attention as tv
    from repro_torch.kernels import verify_attention as va
    from repro_torch.spec.tree import linear_chain, tree_ancestor_masks

    vlens = torch.tensor(VERIFY_LENGTHS, dtype=torch.int32, device="cuda")
    g, k_pool, v_pool, bt = _pool_inputs(torch.bfloat16, seed=4)  # _spec_rows' inputs
    q = torch.randn((B, 5, H, HD), generator=g, device="cuda").to(torch.bfloat16)
    chain = torch.tensor(tree_ancestor_masks(linear_chain(4)), device="cuda").expand(
        B, 5).contiguous()
    names = ("paged_verify_tc_kernel", "combine_splits")
    for name, fn in (
        ("paged_verify_attention", lambda: pv.paged_verify_attention(q, k_pool, v_pool, bt,
                                                                     vlens)),
        ("paged_tree_verify_attention", lambda: ptv.paged_tree_verify_attention(
            q, k_pool, v_pool, bt, vlens, chain)),
    ):
        parts = _kernel_ms_by_name(fn, names)
        row = next(r for r in rows if r["name"] == name)
        row["kernels_ms"] = {"partial": parts[names[0]], "combine": parts[names[1]]}
        log(f"kernel {name} by kernel (median of 30, profiler): " + ", ".join(
            f"{part} {t:.4f} ms" if t is not None else f"{part} not measured"
            for part, t in row["kernels_ms"].items()))
    g, k, v = _dense_inputs(torch.bfloat16, seed=5)  # _dense_target_rows' inputs
    q = torch.randn((B, 5, H, HD), generator=g, device="cuda").to(torch.bfloat16)
    for name, fn in (
        ("verify_attention", lambda: va.verify_attention(q, k, v, vlens)),
        ("tree_verify_attention", lambda: tv.tree_verify_attention(q, k, v, vlens, chain)),
    ):
        t = _kernel_ms_by_name(fn, ("dense_verify_tc_kernel",))["dense_verify_tc_kernel"]
        row = next(r for r in rows if r["name"] == name)
        row["kernels_ms"] = {"cluster kernel": t}
        log(f"kernel {name} by kernel (median of 30, profiler): cluster kernel "
            + (f"{t:.4f} ms, the launch outside it {row['ms'] - t:.4f} ms (CUDA events "
               f"{row['ms']:.4f} ms)" if t is not None else "not measured"))


def _decode_by_kernel(rows):
    """The paged and dense decode's one launch at the table's shapes (bf16;
    the dense one at the draft's H = 8 and the dense target's H = 16): a
    call must be one kernel, the cluster kernel (no ``combine_splits``), and
    one allocation, its output (no scratch); the kernel's profiler span
    against the row's CUDA-event time shows what the launch costs outside
    it.  Runs after every other phase, as ``_verify_by_kernel`` does."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import decode_attention as dd
    from repro_torch.kernels import paged_decode_attention as dec

    lengths = torch.tensor(DECODE_LENGTHS, dtype=torch.int32, device="cuda")
    g, k_pool, v_pool, bt = _pool_inputs(torch.bfloat16)  # phase_kernels' inputs
    q = torch.randn((B, H, HD), generator=g, device="cuda").to(torch.bfloat16)
    dlens = torch.tensor(DENSE_LENGTHS, dtype=torch.int32, device="cuda")
    calls = [("paged_decode_attention", "ms", "paged_decode_cluster_kernel",
              lambda: dec.paged_decode_attention(q, k_pool, v_pool, bt, lengths))]
    for h, key in ((DRAFT_H, "ms"), (H, "ms_target")):
        g, k, v = _dense_inputs(torch.bfloat16, seed=2)  # _spec_rows' inputs
        qd = torch.randn((B, h, HD), generator=g, device="cuda").to(torch.bfloat16)
        calls.append(("decode_attention", key, "dense_decode_cluster_kernel",
                      lambda qd=qd, k=k, v=v: dd.decode_attention(qd, k, v, dlens)))
    flush = torch.empty(1 << 30, dtype=torch.uint8, device="cuda")
    reps = 30
    for name, key, kernel, fn in calls:
        fn()
        torch.cuda.synchronize()
        before = torch.cuda.memory_stats()["allocation.all.allocated"]
        fn()
        allocs = torch.cuda.memory_stats()["allocation.all.allocated"] - before
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
        # the profiler may drop a few events: every kernel it saw (not the
        # flush's) must be the cluster kernel, at most one a call
        seen = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                and "Fill" not in e.name and "emset" not in e.name]
        if allocs != 1 or len(seen) > reps or any(kernel not in e.name for e in seen):
            raise AssertionError(f"{name}: a call made {allocs} allocations, and {reps} calls "
                                 f"launched {sorted({e.name for e in seen})} {len(seen)} times "
                                 f"(one allocation, the output, and only {kernel} expected)")
        spans = sorted((e.time_range.end - e.time_range.start) / 1e3 for e in seen)
        t = spans[len(spans) // 2] if spans else None
        row = next(r for r in rows if r["name"] == name)
        row.setdefault("kernels_ms", {})[f"cluster kernel ({key})"] = t
        log(f"kernel {name} ({key}) by kernel (profiler, median of the {len(seen)} launches "
            f"it saw in {reps} calls, all of {kernel}); one allocation a call; " + (
                f"cluster kernel {t:.4f} ms, the launch outside it {row[key] - t:.4f} ms "
                f"(CUDA events {row[key]:.4f} ms)" if t is not None else
                "the profiler saw no kernel (span not measured)"))


def _dense_target_rows():
    """Rows of the dense target's verify (#6) and tree verify (#8) over dense
    rows at the target's shapes (B=8, H=16, kvH=8, hd=128, S=512): verify at
    T = 2, 3, 5 and the suffix-prefill sizes T = 64, 128 (lengths up to and
    past S), tree at a 5-node chain, branching_tree(2, 2) and the 31-node
    branching_tree(3, 10); both also at GQA group 7, hd 64 (T = 5, T = 64,
    the chain, the 31-node tree) and group 1, 16 / 16 heads (T = 5, the
    chain, the 31-node tree).  A chain's tree verify must equal verify bit
    for bit in both types at every group.  Timed in bf16 at T = 5 / the
    chain, SDPA with an explicit boolean mask as the yardstick; #6 also with
    every slot cut to one 64-key tile, with the longest slot alone, at 1 and
    8 tiles a CTA of the cluster plan, and beside the paged verify's
    two-launch split (#7) over the same rows seen as 16-row pages; #8 also
    at the 31-node tree."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import paged_verify_attention as pv
    from repro_torch.kernels import tree_verify_attention as tv
    from repro_torch.kernels import verify_attention as va
    from repro_torch.spec.tree import branching_tree, linear_chain, tree_ancestor_masks

    S = DENSE_S
    vlens = torch.tensor(VERIFY_LENGTHS, dtype=torch.int32, device="cuda")

    def inputs(t, anc=None, lens=vlens, h=H, kvh=KVH, hd=HD):
        def make(dtype):
            g, k, v = _dense_inputs(dtype, seed=5, hd=hd, kvh=kvh)
            q = torch.randn((B, t, h, hd), generator=g, device="cuda").to(dtype)
            args = (q, k, v, lens)
            return args if anc is None else args + (anc,)
        return make

    def anc_of(parents):
        return torch.tensor(tree_ancestor_masks(parents), device="cuda").expand(
            B, len(parents)).contiguous()

    suffix = {t: torch.tensor(n, dtype=torch.int32, device="cuda")
              for t, n in SUFFIX_LENGTHS.items()}
    g7 = {"h": 28, "kvh": 4, "hd": 64}
    g1 = {"h": 16, "kvh": 16}  # moonshot-v1-16b-a3b: 16 / 16 heads of 128
    vcases = [(f"T={t}", t, {}) for t in VERIFY_TS]
    vcases += [(f"suffix-prefill size, T={t}", t, {"lens": n}) for t, n in suffix.items()]
    vcases += [("group 7, hd 64, T=5", 5, g7),
               ("group 7, hd 64, suffix-prefill size, T=64", 64, {**g7, "lens": suffix[64]}),
               ("group 1, T=5", 5, g1)]
    verr = [_check_kernel(f"verify_attention ({label})", va.verify_attention,
                          va.verify_attention_torch, inputs(t, **kw))
            for label, t, kw in vcases]
    trees = {"linear_chain(4)": linear_chain(4), "branching_tree(2, 2)": branching_tree(2, 2),
             "branching_tree(3, 10), 31 nodes": branching_tree(3, 10)}
    tcases = [(name, par, {}) for name, par in trees.items()]
    tcases += [(f"group {g}, {name}", trees[name], kw)
               for g, kw in (("7, hd 64", g7), ("1", g1))
               for name in ("linear_chain(4)", "branching_tree(3, 10), 31 nodes")]
    terr = [_check_kernel(f"tree_verify_attention ({name})", tv.tree_verify_attention,
                          tv.tree_verify_attention_torch, inputs(len(par), anc_of(par), **kw))
            for name, par, kw in tcases]
    chain = anc_of(linear_chain(4))
    for label, kw in (("", {}), (" (group 7, hd 64)", g7), (" (group 1)", g1)):
        for dtype in (torch.bfloat16, torch.float32):
            args = inputs(5, **kw)(dtype)
            same = torch.equal(tv.tree_verify_attention(*args, chain),
                               va.verify_attention(*args))
            log(f"kernel tree_verify_attention linear_chain(4) vs verify_attention "
                f"T=5{label} {dtype}: bit-equal {same}")
            if not same:
                raise AssertionError("dense tree verify over a chain differs from verify")

    def tree_seen(anc, n):
        """[B, n, S]: node t sees kpos < lengths - n and the nodes of anc[:, t]."""
        kpos = torch.arange(S, device="cuda")
        base = (vlens - n)[:, None, None]
        j = kpos[None, None, :] - base
        bits = (anc[:, :, None] >> j.clamp(0, 31)) & 1
        return (kpos < base) | ((j >= 0) & (j < n) & (bits == 1))

    def bound(q, *anc):
        """bytes: q in and out once, the K/V rows the slots' windows need
        once, lengths (and the tree's masks); operations: QK^T and PV over
        the keys each row sees (``kernels.cost.verify``)."""
        return _cost_bound("verify", q, k, v, vlens, *anc)

    q, k, v, _ = inputs(5)(torch.bfloat16)
    qt = q.transpose(1, 2)
    kt = k.transpose(1, 2).repeat_interleave(H // KVH, 1)
    vt = v.transpose(1, 2).repeat_interleave(H // KVH, 1)
    kpos = torch.arange(S, device="cuda")
    t5 = torch.arange(5, device="cuda")
    vmask = kpos[None, None, :] <= (vlens[:, None] - 5 + t5[None, :])[:, :, None]
    tmask = tree_seen(chain, 5)
    rows = []
    for name, kern, plain, extra, seen, rep, errs in (
        ("verify_attention", va.verify_attention, va.verify_attention_torch, (), vmask,
         "src/repro/kernels/verify_attention.py:110", _worst(*verr)),
        ("tree_verify_attention", tv.tree_verify_attention, tv.tree_verify_attention_torch,
         (chain,), tmask, "src/repro/kernels/tree_verify_attention.py:118", _worst(*terr)),
    ):
        k_ms = _time_ms(lambda: kern(q, k, v, vlens, *extra))
        p_ms = _time_ms(lambda: plain(q, k, v, vlens, *extra))
        l_ms = _time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                               attn_mask=seen[:, None]))
        rows.append(_row(name, "verify_attention.cu", rep, errs, k_ms, p_ms, l_ms,
                         *bound(q, *extra)))
    # what paces #6: every slot cut to its first 64-key tile, the longest slot
    # alone (the others empty), and the paged verify's two-launch split pass
    # + combine over the same rows seen as 16-row pages (identity table)
    one_tile = vlens.clamp(max=64)
    longest = int(torch.argmax(vlens))
    alone = torch.where(torch.arange(B, device="cuda") == longest, vlens,
                        torch.zeros_like(vlens))
    one_tile_ms = _time_ms(lambda: va.verify_attention(q, k, v, one_tile))
    alone_ms = _time_ms(lambda: va.verify_attention(q, k, v, alone))

    def plan_ms(per):
        """#6's time with the cluster plan at ``per`` 64-key tiles a CTA (the
        default is TC_TILES_PER_SPLIT): 1 gives clusters of 8, 8 one CTA a
        slot (a cluster of 1, no peer to read)."""
        default, va.TC_TILES_PER_SPLIT = va.TC_TILES_PER_SPLIT, per
        try:
            return _time_ms(lambda: va.verify_attention(q, k, v, vlens))
        finally:
            va.TC_TILES_PER_SPLIT = default

    plans = {f"ms_{per}_tiles_per_cta": plan_ms(per) for per in (1, 8)}
    cols = S // PAGE
    bt = torch.cat([torch.arange(B * cols, dtype=torch.int32, device="cuda").view(B, cols),
                    torch.zeros((B, 1), dtype=torch.int32, device="cuda")], 1)
    k_pages, v_pages = (x.view(B * cols, PAGE, KVH, HD) for x in (k, v))
    two_ms = _time_ms(lambda: pv.paged_verify_attention(q, k_pages, v_pages, bt, vlens))
    rows[0].update(ms_one_tile_slots=one_tile_ms, ms_longest_slot_alone=alone_ms,
                   ms_two_launch_paged_split=two_ms, **plans)
    log(f"kernel verify_attention: every slot cut to one tile {one_tile_ms:.4f} ms, slot "
        f"{longest} alone {alone_ms:.4f} ms; the paged two-launch split over the same rows "
        f"{two_ms:.4f} ms; at 1 tile a CTA (clusters of 8) {plans['ms_1_tiles_per_cta']:.4f} "
        f"ms, at 8 (one CTA a slot) {plans['ms_8_tiles_per_cta']:.4f} ms")
    anc31 = anc_of(trees["branching_tree(3, 10), 31 nodes"])
    q31 = inputs(31)(torch.bfloat16)[0]  # the same rows, 31 queries
    mask31 = tree_seen(anc31, 31)
    n31_ms = _time_ms(lambda: tv.tree_verify_attention(q31, k, v, vlens, anc31))
    l31_ms = _time_ms(lambda: F.scaled_dot_product_attention(
        q31.transpose(1, 2), kt, vt, attn_mask=mask31[:, None]))
    bound31, _ = bound(q31, anc31)
    rows[1].update(ms_31_nodes=n31_ms, library_ms_31_nodes=l31_ms, bound_ms_31_nodes=bound31)
    log(f"kernel tree_verify_attention (31 nodes): {n31_ms:.4f} ms, sdpa {l31_ms:.4f} ms, "
        f"bound {bound31:.4f} ms")
    return rows


def _ssm_inputs(b, q, seed, di=SSM_DI, ds=SSM_DS):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    xi = torch.randn((b, q, di), generator=g, device="cuda")
    dt = torch.nn.functional.softplus(
        torch.randn((b, q, di), generator=g, device="cuda") - 2)
    bm = torch.randn((b, q, ds), generator=g, device="cuda")
    cm = torch.randn((b, q, ds), generator=g, device="cuda")
    a = -torch.arange(1, ds + 1, dtype=torch.float32, device="cuda").expand(di, ds).contiguous()
    h0 = torch.randn((b, di, ds), generator=g, device="cuda")
    return xi, dt, bm, cm, a, h0


def _ssm_chained(ss, xi, dt, bm, cm, a, h0, chunk=SSM_Q):
    """The same kernel over ``chunk``-step pieces, h carried from one launch
    into the next (the reference's 64-step chunking)."""
    import torch

    ys, h = [], h0
    for c in range(0, xi.shape[1], chunk):
        y, h = ss.ssm_scan_chunk(*(t[:, c: c + chunk].contiguous() for t in (xi, dt, bm, cm)),
                                 a, h)
        ys.append(y)
    return torch.cat(ys, dim=1), h


def _ssm_shapes(b, q, di, ds):
    """The scan's (xi, dt, B, C, A, h0) as ``meta`` tensors (shapes alone)."""
    import torch

    seq, state = torch.empty((b, q, di), device="meta"), torch.empty((b, q, ds), device="meta")
    return (seq, seq, state, state, torch.empty((di, ds), device="meta"),
            torch.empty((b, di, ds), device="meta"))


def _ssm_bound(q, b=1, di=SSM_DI, ds=SSM_DS):
    """Bound of one scan of ``q`` steps over ``b`` batch rows (the table's
    widths unless given).  Bytes: xi, dt, y [b, q, di] and B, C [b, q, ds]
    once, A once, h0 and h [b, di, ds] once; ops: per (row, step, d, state)
    dt*A, exp, *h, fma with dt*x*B, *C, the sum."""
    import torch

    return _cost_bound("ssm_scan", *_ssm_shapes(b, q, di, ds))


def _ssm_rows():
    """The Mamba1 scan (#10), fp32 in and out: held to its plain version at
    B = 1 and 8 and Q in ``SSM_QS`` (d_inner 8192, ssm_state 16), one
    whole-sequence launch against chained 64-step launches of the same
    kernel, and the other state widths at a small, ragged d_inner
    (``SSM_SMALL``); timed at B = 1 for Q = 64 (the table's row) and 256.
    No single PyTorch call computes the scan, so the row has no library
    time."""
    import torch

    from repro_torch.kernels import ssm_scan as ss

    rel = lambda a, r: ((a - r).abs().max() / r.abs().max()).item()
    cases = [(b, q, SSM_DI, SSM_DS) for b in SSM_BATCHES for q in SSM_QS]
    cases += [(2, 65, di, ds) for ds, di in SSM_SMALL]
    err = 0.0
    for b, q, di, ds in cases:
        args = _ssm_inputs(b, q, seed=6, di=di, ds=ds)
        y, h = ss.ssm_scan_chunk(*args)
        cy, ch = _ssm_chained(ss, *args)
        torch.cuda.synchronize()
        ry, rh = ss.ssm_scan_chunk_torch(*args)
        errs = (rel(y, ry), rel(h, rh), rel(y, cy), rel(h, ch))
        if not all(torch.isfinite(t).all() for t in (y, h, cy, ch)):
            raise AssertionError(f"ssm_scan B={b} Q={q} di={di} ds={ds}: non-finite output")
        log(f"kernel ssm_scan B={b} Q={q} di={di} ds={ds} fp32: max err / max|ref| y "
            f"{errs[0]:.2e}, h {errs[1]:.2e}; one launch vs chained {SSM_Q}-step launches: "
            f"y {errs[2]:.2e}, h {errs[3]:.2e} (tol {SSM_RTOL:g})")
        if not max(errs) <= SSM_RTOL:
            raise AssertionError(f"ssm_scan B={b} Q={q} di={di} ds={ds}: errors {errs} > "
                                 f"{SSM_RTOL}")
        err = max(err, *errs)
    times = {}
    for q in (SSM_Q, 256):
        args = _ssm_inputs(1, q, seed=7)
        k_ms = _time_ms(lambda: ss.ssm_scan_chunk(*args))
        p_ms = _time_ms(lambda: ss.ssm_scan_chunk_torch(*args))
        bound, by = _ssm_bound(q)
        times[q] = (k_ms, p_ms, bound, by)
        log(f"kernel ssm_scan (B=1, Q={q}, di={SSM_DI}, ds={SSM_DS}, fp32): {k_ms:.4f} ms, "
            f"plain {p_ms:.4f} ms, library none, bound {bound:.4f} ms ({by})")
    k_ms, p_ms, bound, by = times[SSM_Q]
    return [{
        "name": "ssm_scan", "route": "cuda", "source": "src/repro_torch/kernels/csrc/ssm_scan.cu",
        "replaces": "src/repro/kernels/ssm_scan.py:56", "launches": 0,
        "max_abs_err": err, "err_kind": "relative to max|ref|, fp32",
        "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound, "bound_by": by, "library_ms": None,
        "ms_q256": times[256][0], "plain_ms_q256": times[256][1],
        "bound_ms_q256": times[256][2],
    }]


def _ssm_bwd_bound(b, q, di=SSM_DI, ds=SSM_DS):
    """Bound of the scan's backward: bytes of xi, dt, gy read and gxi, gdt
    written [B, Q, di], B, C read and gB, gC written [B, Q, ds], A and gA,
    h0, the final state's gradient and gh0 once (the forward's checkpoints
    are the kernel's choice, not the function's); operations, per (batch,
    step, row, state), the 20 a step back needs: h rebuilt (dt * A, the
    exponential, a * h, u * B, the sum), g = gy * C + carry, g * h * a, the
    gu, gdt and gA sums (a product and a sum each), the gB and gC terms with
    their sums, the carry a * g."""
    import torch

    return _cost_bound("ssm_scan_bwd", *_ssm_shapes(b, q, di, ds))


def _ptxas_usage(log_text, kernel):
    """{(template arguments): (registers, spill store bytes, spill load
    bytes)} of each instantiation of ``kernel`` in ``ptxas -v`` output."""
    import re

    usage, current = {}, None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            args = re.search(kernel + r"I(.*?)EEv", m.group(1))
            current = tuple(re.findall(r"Li(\d+)E", args.group(1))) if args else None
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            usage[current] = (None, int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            usage[current] = (int(m.group(1)), *usage.get(current, (None, None, None))[1:])
    return usage


def _ssm_bwd_rows(ptxas_log=""):
    """The scan's backward kernel (#10b, ``ssm_scan_bwd``; no TPU
    counterpart: the Pallas scan has no VJP), fp32: at B = 4, Q = 1024 (the
    falcon-mamba training shape) and Q = 200 (not a multiple of the 16-step
    tile), d_inner 8192, ssm_state 16, from a non-zero h0 and with a
    non-zero gradient of the final state, at the other state widths on a
    ragged d_inner (Q = 65 and 33: a last 8-step part of one step; Q = 40: a
    last tile of one part), and at d_inner 2400 (75 CTAs of 32 rows: the last
    8-CTA cluster holds 3 live CTAs and 5 past d_inner); each gradient (xi,
    dt, B, C, A, h0) against autograd of the plain scan within
    SSM_GRAD_RTOL of its largest value, and bit-equal over two launches (the
    sums across CTAs take a fixed order); the forward with checkpoints
    bit-equal to the serving forward (y, h) with hs[:, 0] == h0; a NaN in one
    batch row's xi (at step 37, and at the last step) non-finite exactly
    where the plain version's gradients are, every other row finite.  Timed
    at the training shape beside the plain backward (autograd of the
    step-by-step scan) and the bound; the forward with checkpoints beside the
    serving forward; the registers and spills of every instantiation from
    phase 2's ``ptxas -v`` output of the scan library, ``ptxas_log``.  The
    split between the main kernel and the partials' sum comes from the
    profiler at the end of the run
    (``_ssm_bwd_by_kernel``)."""
    import torch

    from repro_torch.kernels import ssm_scan as ss

    def plain_graph(args):
        leaves = [a.detach().clone().requires_grad_() for a in args]
        return leaves, ss.ssm_scan_chunk_torch(*leaves)

    def plain_grads(args, gy, gh):
        leaves, outs = plain_graph(args)
        return torch.autograd.grad(outs, leaves, (gy, gh))

    names = ("xi", "dt", "B", "C", "A", "h0")
    cases = [(4, 1024, SSM_DI, SSM_DS), (4, 200, SSM_DI, SSM_DS),
             (2, 65, 100, 4), (2, 33, 99, 8), (2, 40, 100, 32), (2, 72, 2400, SSM_DS)]
    worst = 0.0
    for b, q, di, ds in cases:
        args = _ssm_inputs(b, q, seed=9, di=di, ds=ds)
        g = torch.Generator(device="cuda").manual_seed(10)
        gy = torch.randn((b, q, di), generator=g, device="cuda")
        gh = torch.randn((b, di, ds), generator=g, device="cuda")
        y, h, hs = ss.ssm_scan_fwd(*args)
        y0, h0 = ss.ssm_scan_chunk(*args)
        kgrads = ss.ssm_scan_bwd(*args[:5], hs, gy, gh)
        again = ss.ssm_scan_bwd(*args[:5], hs, gy, gh)
        torch.cuda.synchronize()
        if not all(torch.equal(k, k2) for k, k2 in zip(kgrads, again)):
            raise AssertionError(f"ssm_scan_bwd B={b} Q={q} di={di} ds={ds}: two launches "
                                 f"differ: " + ", ".join(
                                     n for n, k, k2 in zip(names, kgrads, again)
                                     if not torch.equal(k, k2)))
        del again
        if not (torch.equal(y, y0) and torch.equal(h, h0) and torch.equal(hs[:, 0], args[5])):
            raise AssertionError(f"ssm_scan_bwd B={b} Q={q} di={di} ds={ds}: the forward "
                                 f"with checkpoints differs from the serving forward")
        pgrads = plain_grads(args, gy, gh)
        errs = {}
        for n, k, p in zip(names, kgrads, pgrads):
            if k.shape != p.shape or not torch.isfinite(k).all():
                raise AssertionError(f"ssm_scan_bwd B={b} Q={q} {n}: shape {tuple(k.shape)} "
                                     f"or non-finite values")
            errs[n] = ((k - p).abs().max() / p.abs().max()).item()
        log(f"kernel ssm_scan_bwd B={b} Q={q} di={di} ds={ds} fp32: max err / max|g| "
            + ", ".join(f"{n} {e:.2e}" for n, e in errs.items())
            + f" (tol {SSM_GRAD_RTOL:g}); two launches bit-equal; forward with checkpoints "
            f"bit-equal")
        if not max(errs.values()) <= SSM_GRAD_RTOL:
            raise AssertionError(f"ssm_scan_bwd B={b} Q={q} di={di} ds={ds}: {errs}")
        worst = max(worst, *errs.values())
        del pgrads, kgrads
    # a NaN in one batch row's xi at one (step, row): mid-sequence, and at
    # the last step (whose state only the last tile's steps past Q carry on)
    b, q = 4, 200
    for nan_row, nan_step in ((1, 37), (2, q - 1)):
        args = list(_ssm_inputs(b, q, seed=11))
        args[0][nan_row, nan_step, 5] = float("nan")
        g = torch.Generator(device="cuda").manual_seed(12)
        gy = torch.randn((b, q, SSM_DI), generator=g, device="cuda")
        gh = torch.randn((b, SSM_DI, SSM_DS), generator=g, device="cuda")
        _, _, hs = ss.ssm_scan_fwd(*args)
        kgrads = ss.ssm_scan_bwd(*args[:5], hs, gy, gh)
        pgrads = plain_grads(args, gy, gh)
        bad = {}
        for n, k, p in zip(names, kgrads, pgrads):
            if not torch.equal(torch.isfinite(k), torch.isfinite(p)):
                raise AssertionError(f"ssm_scan_bwd NaN at row {nan_row}, step {nan_step}: {n} "
                                     f"non-finite at {int((~torch.isfinite(k)).sum())} places, "
                                     f"the plain version's at {int((~torch.isfinite(p)).sum())}")
            bad[n] = int((~torch.isfinite(k)).sum())
            if n != "A":  # every gradient but A's keeps the batch rows apart
                rows = [r for r in range(b) if r != nan_row]
                if not torch.isfinite(k[rows]).all():
                    raise AssertionError(f"ssm_scan_bwd NaN row: {n} non-finite outside row "
                                         f"{nan_row}")
                e = ((k[rows] - p[rows]).abs().max() / p[rows].abs().max()).item()
                if not e <= SSM_GRAD_RTOL:
                    raise AssertionError(f"ssm_scan_bwd NaN row: {n} other rows err {e}")
        log(f"kernel ssm_scan_bwd: a NaN in batch row {nan_row}'s xi at step {nan_step}: "
            f"non-finite gradients exactly where the plain version's are ({json.dumps(bad)}), "
            f"the other rows finite and within {SSM_GRAD_RTOL:g}")
    del kgrads, pgrads
    # times at the training shape
    b, q = 4, 1024
    args = _ssm_inputs(b, q, seed=13)
    g = torch.Generator(device="cuda").manual_seed(14)
    gy = torch.randn((b, q, SSM_DI), generator=g, device="cuda")
    gh = torch.randn((b, SSM_DI, SSM_DS), generator=g, device="cuda")
    _, _, hs = ss.ssm_scan_fwd(*args)
    k_ms = _time_ms(lambda: ss.ssm_scan_bwd(*args[:5], hs, gy, gh))
    fwd_ckpt_ms = _time_ms(lambda: ss.ssm_scan_fwd(*args))
    fwd_ms = _time_ms(lambda: ss.ssm_scan_chunk(*args))
    leaves, outs = plain_graph(args)
    p_ms = _time_ms(lambda: torch.autograd.grad(outs, leaves, (gy, gh), retain_graph=True),
                    reps=5)
    del leaves, outs
    bound, by = _ssm_bwd_bound(b, q)
    fwd_bound, _ = _ssm_bound(q, b)
    usage = {f"ds{a[0]}_v{a[1]}": u for a, u in sorted(
        _ptxas_usage(ptxas_log, "ssm_scan_bwd_kernel").items(),
        key=lambda kv: tuple(map(int, kv[0])))}
    log(f"kernel ssm_scan_bwd (B={b}, Q={q}, di={SSM_DI}, ds={SSM_DS}, fp32): {k_ms:.4f} ms, "
        f"plain (autograd of the step-by-step scan) {p_ms:.4f} ms, library none, bound "
        f"{bound:.4f} ms ({by}), {100 * bound / k_ms:.1f}% of it; forward with checkpoints "
        f"{fwd_ckpt_ms:.4f} ms, serving forward {fwd_ms:.4f} ms (bound {fwd_bound:.4f} ms); "
        f"ptxas (registers, spill store / load bytes): "
        + (", ".join(f"{k} {u}" for k, u in usage.items()) or "not measured (no build log)"))
    return [{
        "name": "ssm_scan_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssm_scan.cu",
        "replaces": "src/repro/kernels/ssm_scan.py:56 (its gradient; the TPU kernel has none)",
        "launches": 0, "max_abs_err": worst, "err_kind": "relative to max|g|, fp32",
        "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound, "bound_by": by, "library_ms": None,
        "ms_fwd_checkpoints": fwd_ckpt_ms, "ms_fwd_serving": fwd_ms,
        "bound_ms_fwd": fwd_bound, "bound_share": bound / k_ms,
        "ptxas": {k: {"registers": u[0], "spill_stores": u[1], "spill_loads": u[2]}
                  for k, u in usage.items()},
    }]


def _ssm_bwd_by_kernel(row):
    """The scan backward's two kernels one by one at the training shape
    (B = 4, Q = 1024, fp32), from ``torch.profiler`` with the L2 flushed
    before each call: the main kernel (``ssm_scan_bwd_kernel``) and the sum
    of the clusters' gB / gC partials and the batch rows' gA
    (``sum_partials_kernel``).  Runs with the other profiler sessions at the
    end of the run."""
    import torch

    from repro_torch.kernels import ssm_scan as ss

    b, q = 4, 1024
    args = _ssm_inputs(b, q, seed=13)
    g = torch.Generator(device="cuda").manual_seed(14)
    gy = torch.randn((b, q, SSM_DI), generator=g, device="cuda")
    gh = torch.randn((b, SSM_DI, SSM_DS), generator=g, device="cuda")
    _, _, hs = ss.ssm_scan_fwd(*args)
    parts = _kernel_ms_by_name(lambda: ss.ssm_scan_bwd(*args[:5], hs, gy, gh),
                               ("ssm_scan_bwd_kernel", "sum_partials_kernel"))
    row["kernels_ms"] = parts
    main = parts["ssm_scan_bwd_kernel"]
    log("kernel ssm_scan_bwd by kernel (median of 30, profiler): " + ", ".join(
        f"{n} {t:.4f} ms" if t is not None else f"{n} not measured" for n, t in parts.items())
        + (f"; main kernel {100 * row['bound_ms'] / main:.1f}% of the whole function's bound"
           if main else ""))


def _hd80_rows():
    """zamba2-2.7b's shared attention at hd 80: flash (#5) forward and
    backward at ``FLASH_HD80_CASES`` and the dense decode (#3) at group 1
    (H = kvH = 32, 8 slots of 512 rows) at the serving lengths and the
    64-key tile edges, each against its plain version in bf16 and fp32, and
    a NaN in one slot through both; timed in bf16 at the hybrid's shapes
    (flash at B=4, H=32, S=1024; decode at the serving lengths) beside SDPA
    and the bound.  Rows ``flash_attention_fwd_hd80``,
    ``flash_attention_bwd_hd80`` and ``decode_attention_hd80``."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as dd

    rows = _flash_rows(FLASH_HD80_CASES, suffix="_hd80")
    _flash_nan_checks(HYB_HD)

    h = kvh = HYB_H
    lengths = torch.tensor(DENSE_LENGTHS, dtype=torch.int32, device="cuda")
    edges = torch.tensor(DENSE_EDGE_LENGTHS, dtype=torch.int32, device="cuda")

    def decode_inputs(lens):
        def make(dtype):
            g, k, v = _dense_inputs(dtype, seed=3, hd=HYB_HD, kvh=kvh)
            q = torch.randn((B, h, HYB_HD), generator=g, device="cuda").to(dtype)
            return q, k, v, lens
        return make

    errs = _worst(*[
        _check_decode(f"decode_attention (hd 80, group 1, H=32{label})", dd.decode_attention,
                      dd.decode_attention_torch, decode_inputs(lens))
        for label, lens in (("", lengths), (", tile edges", edges))])
    _check_nan_slot("decode_attention (hd 80)", dd.decode_attention, dd.decode_attention_torch,
                    decode_inputs(lengths), _poison_dense(2, 100), 2)
    q, k, v, _ = decode_inputs(lengths)(torch.bfloat16)
    k_ms = _time_ms(lambda: dd.decode_attention(q, k, v, lengths))
    p_ms = _time_ms(lambda: dd.decode_attention_torch(q, k, v, lengths))
    mask = (torch.arange(DENSE_S, device="cuda")[None, :] < lengths[:, None])[:, None, None, :]
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)
    l_ms = _time_ms(lambda: F.scaled_dot_product_attention(q[:, :, None], kt, vt,
                                                           attn_mask=mask))
    bound, by = _cost_bound("decode", q, k, v, lengths)
    rows.append(_row("decode_attention_hd80", "decode_attention.cu",
                     "src/repro/kernels/decode_attention.py:92", errs, k_ms, p_ms, l_ms,
                     bound, by))
    return rows


def _slice_rows():
    """The audio / VLM slice's shapes, each kernel against its plain version
    in bf16 and fp32 and timed in bf16 beside SDPA and the bound: flash (#5)
    forward and backward at hd 64 (``FLASH_HD64_CASES``: musicgen-large's
    training shape B=4, H=32, S=1024 causal, a ragged causal case, a
    monolithic bucket) with a NaN in one row; the paged decode (#1) and
    chunked prefill (#2) at musicgen's serving attention (group 1, 32 heads
    of 64) and pixtral-12b's (32 heads over 8 of 128, group 4), the decode
    also at the 64-key tile edges, each with a NaN in one slot; the paged
    verify (#7, T = 5 and a 64-token suffix bucket) and tree verify (#9: a
    chain and the 31-node tree) at musicgen's; the dense decode (#3) at
    pixtral's group 4 (its dense-layout serve).  Rows ``*_hd64`` / ``*_g4``."""
    rows = _flash_rows(FLASH_HD64_CASES, suffix="_hd64")
    _flash_nan_checks(MG_HD)
    for suffix, h, kvh, hd in (("_hd64", MG_H, MG_H, MG_HD), ("_g4", PX_H, PX_KVH, HD)):
        rows.append(_paged_decode_row(suffix, h, kvh, hd))
        rows.append(_paged_prefill_row(suffix, h, kvh, hd))
    rows += _paged_verify_rows("_hd64", MG_H, MG_H, MG_HD)
    rows.append(_dense_decode_row("_g4", PX_H, PX_KVH, HD))
    return rows


def _olmo_rows():
    """olmo-1b's serving attention, 16 MHA heads of 128 (GQA group 1): the
    paged decode (#1) at the serving lengths and the tile edges and the
    chunked prefill (#2), each against its plain version in both dtypes with
    a NaN in one slot, timed in bf16 beside SDPA and the bound.  Rows
    ``*_g1``."""
    return [_paged_decode_row("_g1", OLMO_H, OLMO_H, HD),
            _paged_prefill_row("_g1", OLMO_H, OLMO_H, HD)]


#: the 8-bit cache's check shapes: (label, q heads, KV heads, head dim) --
#: qwen3-1.7b's dense decode at the draft's H = 8 and the target's H = 16
#: over 8 KV heads of 128, musicgen-large's group 1 (32 heads of 64)
FP8_SHAPES = (("H=8", DRAFT_H, KVH, HD), ("H=16", H, KVH, HD),
              ("musicgen group 1, hd 64", MG_H, MG_H, MG_HD))
FP8_TYPES = ("float8_e4m3fn", "float8_e5m2")
#: the rows of the 8-bit cache (their launches: phase 33's 8-bit runs)
FP8_ROWS = ("decode_attention_fp8", "decode_attention_partial_fp8")
#: the partial form's blocks at S = 512 and 4,096 (qwen3-1.7b over model 16
#: and 2)
FP8_SPLITS = {512: 16, 4096: 2}


def _fp8_cache(dtype, g, b, s, kvh, hd):
    """K or V rows ``[b, s, kvh, hd]`` in an 8-bit type, cast as the cache
    writes them (``layers.to_cache``) from N(0, 1) fp32."""
    import torch

    from repro_torch.models import layers as L

    return L.to_cache(torch.randn((b, s, kvh, hd), generator=g, device="cuda"),
                      getattr(torch, dtype))


def _check_fp8(name, kernel, plain, make):
    """The kernel against its plain version on the same 8-bit cache (the
    plain version widens it itself), q in bf16 and fp32: the error relative
    to max |out| within ``BF16_ATOL`` / ``FP32_ATOL``, a slot with lengths <=
    0 exactly zero; then a NaN code at one live K position of slot 1 (live
    at both lengths' sets) comes out where the plain version's does, the
    other slots bit-equal.  Returns
    the absolute errors by q dtype, and the relative ones (``*_rel``)."""
    import torch

    errs = {}
    for dtype, tol in ((torch.bfloat16, BF16_ATOL), (torch.float32, FP32_ATOL)):
        q, k, v, lens = make(dtype)
        out = kernel(q, k, v, lens)
        torch.cuda.synchronize()
        ref = plain(q.float(), k, v, lens)
        abs_err = (out.float() - ref).abs().max().item()
        err = abs_err / ref.abs().max().item()
        errs[str(dtype).split(".")[-1]] = abs_err
        errs[str(dtype).split(".")[-1] + "_rel"] = err
        if not (torch.isfinite(out).all() and err <= tol):
            raise AssertionError(f"{name} {dtype}: error {err:.3e} of max |out| (tolerance "
                                 f"{tol:g}) or a non-finite output")
        if out[lens <= 0].any():
            raise AssertionError(f"{name} {dtype}: a slot with lengths <= 0 is not zeros")
        poisoned = k.view(torch.uint8).clone()
        poisoned[1, 50, 0, 5] = 0x7F  # a NaN code in both 8-bit types
        poisoned = poisoned.view(k.dtype)
        bad_out = kernel(q, poisoned, v, lens)
        bad_ref = plain(q.float(), poisoned, v, lens)
        bad, ref_bad = ~torch.isfinite(bad_out), ~torch.isfinite(bad_ref)
        others = [i for i in range(out.shape[0]) if i != 1]
        if not (bad[1].any() and torch.equal(bad, ref_bad)
                and torch.equal(bad_out[others], out[others])):
            raise AssertionError(f"{name} {dtype}: a NaN code in slot 1 does not come out "
                                 "where the plain version's does, or changed another slot")
        log(f"kernel {name} {dtype}: error {err:.3e} of max |out| (tolerance {tol:g}); a NaN "
            f"code -> {int(bad.sum())} non-finite outputs where the plain version's are")
    return errs


def _fp8_rows():
    """#3 and its partial form over an 8-bit K / V cache (the serve steps'
    ``cache_dtype``), each against its plain version on the same cache
    (``_check_fp8``: both 8-bit types, q in bf16 and fp32, ``FP8_SHAPES``,
    S = 512 and 4,096 with an empty slot; the partial form over
    ``FP8_SPLITS`` blocks merged by ``combine_splits``); timed with bf16 q
    over an e4m3 cache at qwen3-1.7b's dense target shape (H = 16) beside
    #3 over the same values in a bf16 cache, the bytes bound, SDPA over the
    cache widened to bf16 (the widening timed apart) and, at 4,096 keys, the
    same again.  Rows ``decode_attention_fp8`` and
    ``decode_attention_partial_fp8`` (their launches: phase 33's fp8 serve
    steps and the sequence-parallel fp8 stand-in)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as dd

    def make_inputs(fp8, h, kvh, hd, s, lens, seed=38):
        def make(dtype):
            g = torch.Generator(device="cuda").manual_seed(seed)
            k = _fp8_cache(fp8, g, B, s, kvh, hd)
            v = _fp8_cache(fp8, g, B, s, kvh, hd)
            q = torch.randn((B, h, hd), generator=g, device="cuda").to(dtype)
            return q, k, v, lens
        return make

    lengths = {DENSE_S: _i32(DENSE_LENGTHS), LONG_S: _i32(LONG_LENGTHS)}
    whole, parts = [], []
    for fp8 in FP8_TYPES:
        for label, h, kvh, hd in FP8_SHAPES:
            for s, lens in lengths.items():
                make = make_inputs(fp8, h, kvh, hd, s, lens)
                tag = f"({fp8}, {label}, S={s})"
                whole.append(_check_fp8(f"decode_attention_fp8 {tag}", dd.decode_attention,
                                        dd.decode_attention_torch, make))
                m = FP8_SPLITS[s]
                parts.append(_check_fp8(f"decode_attention_partial_fp8 + combine_splits (m={m})"
                                        f" {tag}", _seq_parallel(m),
                                        _seq_parallel(m, plain=True), make))

    def times(s, lens):
        """(#3 over the e4m3 cache, over a bf16 cache of the same values,
        SDPA over the widened cache, the widening, the plain version, bound,
        bound by) in ms at the dense target's H = 16."""
        q, k, v, _ = make_inputs("float8_e4m3fn", H, KVH, HD, s, lens)(torch.bfloat16)
        kb, vb = k.to(torch.bfloat16), v.to(torch.bfloat16)
        k_ms = _time_ms(lambda: dd.decode_attention(q, k, v, lens))
        b_ms = _time_ms(lambda: dd.decode_attention(q, kb, vb, lens))
        mask = (torch.arange(s, device="cuda")[None, :] < lens[:, None])[:, None, None, :]
        kt = kb.transpose(1, 2).repeat_interleave(H // KVH, 1)
        vt = vb.transpose(1, 2).repeat_interleave(H // KVH, 1)
        l_ms = _time_ms(lambda: F.scaled_dot_product_attention(q[:, :, None], kt, vt,
                                                               attn_mask=mask))
        w_ms = _time_ms(lambda: (k.to(torch.bfloat16), v.to(torch.bfloat16)))
        p_ms = _time_ms(lambda: dd.decode_attention_torch(q, k, v, lens))
        bound, by = _cost_bound("decode", q, k, v, lens)
        return k_ms, b_ms, l_ms, w_ms, p_ms, bound, by

    k_ms, b_ms, l_ms, w_ms, p_ms, bound, by = times(DENSE_S, lengths[DENSE_S])
    row = {"name": "decode_attention_fp8", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/decode_attention_fp8.cu",
           "replaces": "src/repro/kernels/decode_attention.py:92", "launches": 0,
           "max_abs_err": max(e["bfloat16"] for e in whole),
           "max_abs_err_fp32": max(e["float32"] for e in whole),
           "max_rel_err": max(e["bfloat16_rel"] for e in whole),
           "max_rel_err_fp32": max(e["float32_rel"] for e in whole), "ms": k_ms,
           "plain_ms": p_ms, "bound_ms": bound, "bound_by": by, "library_ms": l_ms,
           "ms_bf16_cache": b_ms, "widen_ms": w_ms}
    k4, b4, l4, w4, _, bound4, _ = times(LONG_S, lengths[LONG_S])
    row.update(ms_4096_keys=k4, ms_bf16_cache_4096_keys=b4, library_ms_4096_keys=l4,
               widen_ms_4096_keys=w4, bound_ms_4096_keys=bound4)
    log(f"kernel decode_attention_fp8 ({_card()}; e4m3 cache, bf16 q, B={B}, H={H}, "
        f"kvH={KVH}, hd {HD}): S={DENSE_S} {k_ms:.4f} ms (bf16 cache {b_ms:.4f}; plain "
        f"{p_ms:.4f}; sdpa over the widened cache {l_ms:.4f} + widening {w_ms:.4f}; bound "
        f"{bound:.4f} by {by}); S={LONG_S} {k4:.4f} ms (bf16 cache {b4:.4f}; sdpa {l4:.4f} + "
        f"widening {w4:.4f}; bound {bound4:.4f}); errors of max |out| bf16 q "
        f"{row['max_rel_err']:.3e}, fp32 q {row['max_rel_err_fp32']:.3e}")

    # the partial form: one rank's block of qwen3-1.7b's 512-row cache over
    # model 16 (32 rows), as phase 32 times it
    m = FP8_SPLITS[DENSE_S]
    blk = DENSE_S // m
    q, k, v, lens = make_inputs("float8_e4m3fn", H, KVH, HD, DENSE_S,
                                lengths[DENSE_S])(torch.bfloat16)
    kb8 = k.view(torch.uint8)[:, :blk].contiguous().view(k.dtype)
    vb8 = v.view(torch.uint8)[:, :blk].contiguous().view(v.dtype)
    lb = lens.clamp(0, blk).to(torch.int32)
    part_ms = _time_ms(lambda: dd.decode_attention_partial(q, kb8, vb8, lb))
    kbw, vbw = kb8.to(torch.bfloat16), vb8.to(torch.bfloat16)
    part_bf16 = _time_ms(lambda: dd.decode_attention_partial(q, kbw, vbw, lb))
    part_plain = _time_ms(lambda: dd.decode_partial_core(q, kb8, vb8, lb))
    group = H // KVH
    lk, lv = (t.to(torch.bfloat16).permute(0, 2, 1, 3).repeat_interleave(group, 1).contiguous()
              for t in (kb8, vb8))
    keep = torch.arange(blk, device="cuda")[None, :] < lb[:, None]
    bias = torch.zeros((B, H, 1, blk), dtype=torch.bfloat16, device="cuda").masked_fill(
        ~keep[:, None, None], float("-inf"))
    sdpa = torch.ops.aten._scaled_dot_product_efficient_attention
    lib_ms = _time_ms(lambda: sdpa(q[:, :, None], lk, lv, bias, True))
    widen_ms = _time_ms(lambda: (kb8.to(torch.bfloat16), vb8.to(torch.bfloat16)))
    p_bound, p_by = _cost_bound("decode_partial", q, kb8, vb8, lb)
    log(f"kernel decode_attention_partial_fp8 ({_card()}; one block of {blk} of S={DENSE_S}, "
        f"e4m3 cache, bf16 q): {part_ms:.4f} ms (bf16 cache {part_bf16:.4f}; plain {part_plain:.4f}; memory-efficient SDPA over the widened "
        f"block {lib_ms:.4f} + widening {widen_ms:.4f}; bound {p_bound:.4f} by {p_by})")
    return [row, {
        "name": "decode_attention_partial_fp8", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_attention_fp8.cu",
        "replaces": "src/repro/kernels/decode_attention.py:92", "launches": 0,
        "max_abs_err": max(e["bfloat16"] for e in parts),
        "max_abs_err_fp32": max(e["float32"] for e in parts),
        "max_rel_err": max(e["bfloat16_rel"] for e in parts),
        "max_rel_err_fp32": max(e["float32_rel"] for e in parts), "ms": part_ms,
        "plain_ms": part_plain, "bound_ms": p_bound, "bound_by": p_by, "library_ms": lib_ms,
        "widen_ms": widen_ms}]


def _i32(xs):
    import torch

    return torch.tensor(xs, dtype=torch.int32, device="cuda")


def _paged_sdpa(q4, k_pool, v_pool, bt, mask, group):
    """SDPA's time over the pre-gathered pages (the gather not timed): q4
    [B, H, T, hd], ``mask`` [B, T, S] of visible keys."""
    import torch.nn.functional as F

    from repro_torch.kernels import paged_decode_attention as dec

    kd = dec.gather_pages(k_pool, bt).transpose(1, 2).repeat_interleave(group, 1)
    vd = dec.gather_pages(v_pool, bt).transpose(1, 2).repeat_interleave(group, 1)
    return _time_ms(lambda: F.scaled_dot_product_attention(q4, kd, vd,
                                                           attn_mask=mask[:, None]))


def _paged_decode_row(suffix, h, kvh, hd):
    """#1 at ``h`` / ``kvh`` heads of ``hd``: checked at the serving lengths
    and the tile edges, a NaN in slot 1, timed at the serving lengths."""
    import torch

    from repro_torch.kernels import paged_decode_attention as dec

    def make_inputs(lens):
        def make(dtype):
            g, k_pool, v_pool, bt = _pool_inputs(dtype, seed=11, hd=hd, kvh=kvh)
            q = torch.randn((B, h, hd), generator=g, device="cuda").to(dtype)
            return q, k_pool, v_pool, bt, lens
        return make

    label = f"paged_decode_attention ({h} / {kvh} heads of {hd}"
    lengths = _i32(DECODE_LENGTHS)
    errs = _worst(*[
        _check_decode(f"{label}{tag})", dec.paged_decode_attention,
                      dec.paged_decode_attention_torch, make_inputs(lens))
        for tag, lens in (("", lengths), (", tile edges", _i32(DECODE_EDGE_LENGTHS)))])
    _check_nan_slot(f"{label})", dec.paged_decode_attention, dec.paged_decode_attention_torch,
                    make_inputs(lengths), _poison_paged(1, 100), 1)
    q, k_pool, v_pool, bt, _ = make_inputs(lengths)(torch.bfloat16)
    k_ms = _time_ms(lambda: dec.paged_decode_attention(q, k_pool, v_pool, bt, lengths))
    p_ms = _time_ms(lambda: dec.paged_decode_attention_torch(q, k_pool, v_pool, bt, lengths))
    s = NCOLS * PAGE
    mask = torch.arange(s, device="cuda")[None, None, :] < lengths[:, None, None]
    l_ms = _paged_sdpa(q[:, :, None], k_pool, v_pool, bt, mask, h // kvh)
    bound, by = _cost_bound("paged_decode", q, k_pool, v_pool, bt, lengths)
    return _row("paged_decode_attention" + suffix, "paged_decode_attention.cu",
                "src/repro/kernels/paged_decode_attention.py:53", errs, k_ms, p_ms, l_ms,
                bound, by)


def _paged_prefill_row(suffix, h, kvh, hd):
    """#2 at ``h`` / ``kvh`` heads of ``hd``: 32-token chunks at the serving
    starts, a NaN in slot 2."""
    import torch

    from repro_torch.kernels import paged_prefill_attention as pre

    starts, clens = _i32(PREFILL_STARTS), _i32(PREFILL_LENS)

    def make(dtype):
        g, k_pool, v_pool, bt = _pool_inputs(dtype, seed=12, hd=hd, kvh=kvh)
        q = torch.randn((B, CHUNK, h, hd), generator=g, device="cuda").to(dtype)
        return q, k_pool, v_pool, bt, starts, clens

    label = f"paged_prefill_attention ({h} / {kvh} heads of {hd})"
    errs = _check_kernel(label, pre.paged_prefill_attention, pre.paged_prefill_attention_torch,
                         make)
    _check_nan_slot(label, pre.paged_prefill_attention, pre.paged_prefill_attention_torch,
                    make, _poison_paged(2, 50), 2)
    q, k_pool, v_pool, bt, _, _ = make(torch.bfloat16)
    k_ms = _time_ms(lambda: pre.paged_prefill_attention(q, k_pool, v_pool, bt, starts, clens))
    p_ms = _time_ms(lambda: pre.paged_prefill_attention_torch(q, k_pool, v_pool, bt, starts,
                                                              clens))
    s = NCOLS * PAGE
    t = torch.arange(CHUNK, device="cuda")
    mask = ((torch.arange(s, device="cuda")[None, None, :]
             <= (starts[:, None] + t[None, :])[:, :, None])
            & (t[None, :, None] < clens[:, None, None]))
    l_ms = _paged_sdpa(q.transpose(1, 2), k_pool, v_pool, bt, mask, h // kvh)
    bound, by = _cost_bound("paged_prefill", q, k_pool, v_pool, bt, starts, clens)
    return _row("paged_prefill_attention" + suffix, "paged_prefill_attention.cu",
                "src/repro/kernels/paged_prefill_attention.py:50", errs, k_ms, p_ms, l_ms,
                bound, by)


def _paged_verify_rows(suffix, h, kvh, hd):
    """#7 (T = 5 and a 64-token suffix bucket) and #9 (a 4-draft chain, bit-
    equal to #7 at T = 5, and the 31-node tree) at ``h`` / ``kvh`` heads of
    ``hd``, a NaN in slot 1; timed at T = 5 (both) and the 31-node tree."""
    import torch

    from repro_torch.kernels import paged_tree_verify_attention as ptv
    from repro_torch.kernels import paged_verify_attention as pv
    from repro_torch.spec.tree import branching_tree, linear_chain, tree_ancestor_masks

    vlens = _i32(VERIFY_LENGTHS)
    cap = NCOLS * PAGE

    def make_inputs(t, lens=vlens, anc=None):
        def make(dtype):
            g, k_pool, v_pool, bt = _pool_inputs(dtype, seed=13, hd=hd, kvh=kvh)
            q = torch.randn((B, t, h, hd), generator=g, device="cuda").to(dtype)
            args = (q, k_pool, v_pool, bt, lens)
            return args if anc is None else args + (anc,)
        return make

    def anc_of(parents):
        return torch.tensor(tree_ancestor_masks(parents), device="cuda").expand(
            B, len(parents)).contiguous()

    shape = f"{h} / {kvh} heads of {hd}"
    verr = _worst(*[
        _check_kernel(f"paged_verify_attention ({shape}, {tag})", pv.paged_verify_attention,
                      pv.paged_verify_attention_torch, make_inputs(t, lens))
        for tag, t, lens in (("T=5", 5, vlens),
                             ("suffix prefill, T=64", 64, _i32(SUFFIX_LENGTHS[64])))])
    chain, tree31 = anc_of(linear_chain(4)), anc_of(branching_tree(3, 10))
    terr = _worst(*[
        _check_kernel(f"paged_tree_verify_attention ({shape}, {tag})",
                      ptv.paged_tree_verify_attention, ptv.paged_tree_verify_attention_torch,
                      make_inputs(n, anc=anc))
        for tag, n, anc in (("linear_chain(4)", 5, chain), ("31 nodes", 31, tree31))])
    for dtype in (torch.bfloat16, torch.float32):
        args = make_inputs(5)(dtype)
        if not torch.equal(ptv.paged_tree_verify_attention(*args, chain),
                           pv.paged_verify_attention(*args)):
            raise AssertionError(f"tree verify over a chain differs from verify ({shape})")
    _check_nan_slot(f"paged_verify_attention ({shape})", pv.paged_verify_attention,
                    pv.paged_verify_attention_torch, make_inputs(5), _poison_paged(1, 100), 1)
    _check_nan_slot(f"paged_tree_verify_attention ({shape})", ptv.paged_tree_verify_attention,
                    ptv.paged_tree_verify_attention_torch, make_inputs(5, anc=chain),
                    _poison_paged(1, 100), 1)
    q, k_pool, v_pool, bt, _ = make_inputs(5)(torch.bfloat16)
    q31 = make_inputs(31)(torch.bfloat16)[0]
    kpos = torch.arange(cap, device="cuda")

    def seen(anc, n):
        """[B, n, cap]: node t sees kpos < lengths - n and its ancestors."""
        base = (vlens - n)[:, None, None]
        j = kpos[None, None, :] - base
        bits = (anc[:, :, None] >> j.clamp(0, 31)) & 1
        return (kpos < base) | ((j >= 0) & (j < n) & (bits == 1))

    def bound(q, *anc):
        return _cost_bound("paged_verify", q, k_pool, v_pool, bt, vlens, *anc)

    mask5, mask31 = seen(chain, 5), seen(tree31, 31)
    rows = []
    for name, src, replaces, errs, kern, plain, extra in (
        ("paged_verify_attention", "paged_verify_attention.cu",
         "src/repro/kernels/paged_verify_attention.py:45", verr, pv.paged_verify_attention,
         pv.paged_verify_attention_torch, ()),
        ("paged_tree_verify_attention", "paged_tree_verify_attention.cu",
         "src/repro/kernels/paged_tree_verify_attention.py:45", terr,
         ptv.paged_tree_verify_attention, ptv.paged_tree_verify_attention_torch, (chain,)),
    ):
        k_ms = _time_ms(lambda: kern(q, k_pool, v_pool, bt, vlens, *extra))
        p_ms = _time_ms(lambda: plain(q, k_pool, v_pool, bt, vlens, *extra))
        l_ms = _paged_sdpa(q.transpose(1, 2), k_pool, v_pool, bt, mask5, h // kvh)
        rows.append(_row(name + suffix, src, replaces, errs, k_ms, p_ms, l_ms,
                         *bound(q, *extra)))
    n31_ms = _time_ms(lambda: ptv.paged_tree_verify_attention(q31, k_pool, v_pool, bt, vlens,
                                                              tree31))
    l31_ms = _paged_sdpa(q31.transpose(1, 2), k_pool, v_pool, bt, mask31, h // kvh)
    bound31, _ = bound(q31, tree31)
    rows[1].update(ms_31_nodes=n31_ms, library_ms_31_nodes=l31_ms, bound_ms_31_nodes=bound31)
    log(f"kernel paged_tree_verify_attention{suffix} (31 nodes): {n31_ms:.4f} ms, sdpa "
        f"{l31_ms:.4f} ms, bound {bound31:.4f} ms")
    return rows


def _dense_decode_row(suffix, h, kvh, hd):
    """#3 at ``h`` / ``kvh`` heads of ``hd`` over 8 dense 512-row slots, at
    the serving lengths and the tile edges (past S too), a NaN in slot 2."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as dd

    def make_inputs(lens):
        def make(dtype):
            g, k, v = _dense_inputs(dtype, seed=14, hd=hd, kvh=kvh)
            q = torch.randn((B, h, hd), generator=g, device="cuda").to(dtype)
            return q, k, v, lens
        return make

    label = f"decode_attention ({h} / {kvh} heads of {hd}"
    lengths = _i32(DENSE_LENGTHS)
    errs = _worst(*[
        _check_decode(f"{label}{tag})", dd.decode_attention, dd.decode_attention_torch,
                      make_inputs(lens))
        for tag, lens in (("", lengths), (", tile edges", _i32(DENSE_EDGE_LENGTHS)))])
    _check_nan_slot(f"{label})", dd.decode_attention, dd.decode_attention_torch,
                    make_inputs(lengths), _poison_dense(2, 100), 2)
    q, k, v, _ = make_inputs(lengths)(torch.bfloat16)
    k_ms = _time_ms(lambda: dd.decode_attention(q, k, v, lengths))
    p_ms = _time_ms(lambda: dd.decode_attention_torch(q, k, v, lengths))
    mask = (torch.arange(DENSE_S, device="cuda")[None, :] < lengths[:, None])[:, None, None, :]
    kt = k.transpose(1, 2).repeat_interleave(h // kvh, 1)
    vt = v.transpose(1, 2).repeat_interleave(h // kvh, 1)
    l_ms = _time_ms(lambda: F.scaled_dot_product_attention(q[:, :, None], kt, vt,
                                                           attn_mask=mask))
    bound, by = _cost_bound("decode", q, k, v, lengths)
    return _row("decode_attention" + suffix, "decode_attention.cu",
                "src/repro/kernels/decode_attention.py:92", errs, k_ms, p_ms, l_ms, bound, by)


def _poison_paged(slot, pos):
    """A NaN at K position ``pos`` of ``slot`` (kv head 1) of a paged
    kernel's (q, k_pool, v_pool, block_tables, ...) arguments, in a copy of
    the K pool."""
    def poison(args):
        k = args[1].clone()
        k[int(args[3][slot, pos // PAGE]), pos % PAGE, 1, 5] = float("nan")
        return (args[0], k, *args[2:])
    return poison


def _poison_dense(slot, pos):
    """A NaN at K position ``pos`` of ``slot`` (kv head 1) of a dense
    kernel's (q, k, v, ...) arguments, in a copy of K."""
    def poison(args):
        k = args[1].clone()
        k[slot, pos, 1, 5] = float("nan")
        return (args[0], k, *args[2:])
    return poison


# ---------------------------------------------------------------------------
# 4. parity
# ---------------------------------------------------------------------------


def _prompts(rng, n, lo, hi, vocab, shared_prefix, shared_idx):
    """``n`` random prompts of ``lo``..``hi`` tokens; those at ``shared_idx``
    start with one common ``shared_prefix``-token prefix.  The first of them
    is admitted in the first wave and the rest after slots free, so the
    later ones hit the radix cache."""
    import numpy as np

    prefix = rng.integers(0, vocab, shared_prefix)
    out = []
    for i in range(n):
        p = rng.integers(0, vocab, int(rng.integers(lo, hi + 1)))
        if i in shared_idx:
            p = np.concatenate([prefix, p])
        out.append(p.astype(np.int32))
    return out


def _serve(engine, prompts, max_new, steps=None):
    """Submit every prompt (ONLINE, arrival now) and step the core until all
    finish; returns the requests and the wall seconds.  ``steps``, a list,
    collects every step's ``StepOutputs``."""
    import torch

    from repro_torch.serving.core import Priority, SamplingParams

    core = engine.core
    reqs = [core.submit(p, SamplingParams(max_new_tokens=max_new),
                        priority=Priority.ONLINE) for p in prompts]
    t0 = time.monotonic()
    guard = 0
    while core.has_unfinished:
        out = core.step()
        if steps is not None:
            steps.append(out)
        guard += 1
        if guard > 10_000:
            raise AssertionError("serve loop made no progress")
    torch.cuda.synchronize()
    return reqs, time.monotonic() - t0


def _model_step_parity(label, cfg, params, rng):
    """Model steps with impl="cuda" and impl="torch" on the same fp32 weights
    and paged cache: two chunk waves (ragged, a frozen slot, starts > 0; the
    tokens drawn from ``rng``), one decode step, one fused loop with
    per-slot freeze.  Next tokens and the loop's streams must be equal, K/V
    within FP32_ATOL and the decode logits within LOGITS_ATOL."""
    import torch

    from repro_torch.models import transformer as T

    b, per_slot = 4, 8
    bt = torch.zeros((b, per_slot + 1), dtype=torch.int32)
    bt[:, :per_slot] = torch.randperm(b * per_slot, generator=torch.Generator().manual_seed(0)
                                      ).reshape(b, per_slot) + 1
    toks = torch.tensor(rng.integers(0, cfg.vocab_size, (2, b, CHUNK)), dtype=torch.int32,
                        device="cuda")
    waves = [torch.tensor(w, dtype=torch.int32, device="cuda")
             for w in ([32, 32, 7, 0], [8, 0, 0, 25])]
    results = {}
    for impl in ("cuda", "torch"):
        cache = T.init_paged_cache(cfg, b, b * per_slot + 1, PAGE, per_slot, torch.float32)
        cache["block_tables"] = bt.to("cuda")
        firsts = []
        for w, lens in enumerate(waves):
            nt, cache = T.prefill_chunks_into_slots(
                cfg, params, toks[w], lens, cache, compute_dtype=torch.float32,
                attn_impl=impl,
            )
            firsts.append(nt)
        first = torch.where(waves[1] > 0, firsts[1], firsts[0])
        logits, cache = T.decode_step(cfg, params, first, cache,
                                      compute_dtype=torch.float32, attn_impl=impl)
        out = T.decode_loop(cfg, params, logits.argmax(-1).to(torch.int32), cache,
                            torch.tensor([8, 8, 3, 0], dtype=torch.int32, device="cuda"),
                            k=8, max_seq=per_slot * PAGE, compute_dtype=torch.float32,
                            attn_impl=impl)
        torch.cuda.synchronize()
        results[impl] = (first, logits, out[3], cache["layers"]["k"], cache["layers"]["v"])
    (f_c, l_c, s_c, k_c, v_c), (f_t, l_t, s_t, k_t, v_t) = results["cuda"], results["torch"]
    kv_err = max((k_c[:, 1:] - k_t[:, 1:]).abs().max().item(),
                 (v_c[:, 1:] - v_t[:, 1:]).abs().max().item())
    logit_err = (l_c - l_t).abs().max().item()
    if not torch.equal(f_c, f_t):
        raise AssertionError(f"{label}: prefill next tokens differ (cuda vs torch)")
    if not (kv_err <= FP32_ATOL):
        raise AssertionError(f"{label}: prefill K/V differ by {kv_err} > {FP32_ATOL}")
    if not (logit_err <= LOGITS_ATOL and torch.isfinite(l_c).all()):
        raise AssertionError(f"{label}: decode logits differ by {logit_err} > {LOGITS_ATOL}")
    if not torch.equal(s_c, s_t):
        raise AssertionError(f"{label}: decode_loop token streams differ")
    log(f"{label} (2 layers, full width, fp32): prefill K/V max err {kv_err:.2e}, "
        f"decode logits max err {logit_err:.2e} (tol {LOGITS_ATOL:g}), tokens equal")


def phase_parity():
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import InferenceEngine

    cfg = dataclasses.replace(configs.get_config("qwen3-1.7b"), num_layers=2)
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    rng = np.random.default_rng(0)
    _model_step_parity("parity model", cfg, params, rng)

    # the engine: same requests through EngineCore with either impl
    streams = {}
    for impl in ("cuda", "torch"):
        eng = InferenceEngine(cfg, params, max_slots=4, max_seq=256,
                              compute_dtype=torch.float32, decode_impl=impl)
        prompts = _prompts(np.random.default_rng(1), 6, 24, 80, cfg.vocab_size,
                           shared_prefix=32, shared_idx=(0, 5))
        reqs, _ = _serve(eng, prompts, max_new=8)
        streams[impl] = [list(r.output_tokens) for r in reqs]
        if impl == "cuda":
            graphs = _decode_graph_launches("parity engine", eng, cfg)
    if streams["cuda"] != streams["torch"]:
        raise AssertionError("parity: EngineCore token streams differ (cuda vs torch)")
    log(f"parity engine: {len(streams['cuda'])} requests, token streams equal; the cuda "
        f"engine's decode graphs captured {graphs} paged decode launches (k: launches)")
    _spec_parity(cfg, params)
    _dense_target_parity(cfg, params)
    _ssm_parity()

    # training: lm_loss and every gradient, flash kernels vs plain version
    from repro_torch.tree import tree_leaves

    for p in tree_leaves(params):
        p.requires_grad_(True)
    toks = torch.tensor(rng.integers(0, cfg.vocab_size, (2, 257)), dtype=torch.int32,
                        device="cuda")
    res = {}
    for impl in ("cuda", "torch"):
        loss, _ = T.lm_loss(cfg, params, toks[:, :-1], toks[:, 1:], impl=impl,
                            compute_dtype=torch.float32)
        res[impl] = (loss.detach(), torch.autograd.grad(loss, tree_leaves(params)))
    torch.cuda.synchronize()
    loss_err = (res["cuda"][0] - res["torch"][0]).abs().item()
    grad_err = max(((a - b).abs().max() / b.abs().max()).item()
                   for a, b in zip(res["cuda"][1], res["torch"][1]))
    if not (torch.isfinite(res["cuda"][0]) and loss_err <= 1e-5 * res["torch"][0].abs().item()):
        raise AssertionError(f"parity: lm_loss differs by {loss_err}")
    if not grad_err <= GRAD_RTOL_FP32:
        raise AssertionError(f"parity: gradients differ by {grad_err} of max|g|")
    log(f"parity train (2 layers, full width, fp32, B=2, S=256): loss "
        f"{res['torch'][0].item():.6f}, |d| {loss_err:.2e} (tol 1e-5 relative); "
        f"gradients max err / max|g| {grad_err:.2e} (tol {GRAD_RTOL_FP32:g})")
    del params, res


def _spec_parity(cfg, params):
    """Speculating engines at 2 layers, full width, fp32: the draft-paired
    engine, the n-gram engine and the target paired with itself as its draft
    (acceptance 1.0: the all-accept branch) give the same token streams with
    impl="cuda" as with impl="torch", and the plain greedy engine's."""
    import numpy as np
    import torch

    from repro_torch.configs import SpecDecodeConfig, draft_config
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import InferenceEngine

    dcfg = draft_config(cfg)
    dparams = T.init_params(dcfg, torch.Generator(device="cuda").manual_seed(1))
    pairings = {
        "plain": {},
        "draft": dict(draft_cfg=dcfg, draft_params=dparams,
                      spec=SpecDecodeConfig(proposer="draft")),
        "ngram": dict(spec=SpecDecodeConfig(proposer="ngram")),
        "self-draft": dict(draft_cfg=cfg, draft_params=params,
                           spec=SpecDecodeConfig(proposer="draft")),
    }
    prompts = _prompts(np.random.default_rng(1), 6, 24, 80, cfg.vocab_size,
                       shared_prefix=32, shared_idx=(0, 5))
    streams, stats, all_accepted = {}, {}, {}
    for name, kw in pairings.items():
        for impl in ("cuda", "torch") if name != "plain" else ("cuda",):
            eng = InferenceEngine(cfg, params, max_slots=4, max_seq=256,
                                  compute_dtype=torch.float32, decode_impl=impl, **kw)
            steps = []
            reqs, _ = _serve(eng, prompts, max_new=12, steps=steps)
            streams[name, impl] = [list(r.output_tokens) for r in reqs]
            stats[name, impl] = (eng.spec_rounds, eng.spec_accepted, eng.spec_drafted)
            # steps whose every proposed draft token was accepted
            all_accepted[name, impl] = sum(
                0 < o.spec_proposed == o.spec_accepted for o in steps)
    plain = streams["plain", "cuda"]
    for name in ("draft", "ngram", "self-draft"):
        if streams[name, "cuda"] != streams[name, "torch"]:
            raise AssertionError(f"parity: {name} speculating streams differ (cuda vs torch)")
        if streams[name, "cuda"] != plain:
            raise AssertionError(f"parity: {name} speculating streams differ from plain greedy")
        if stats[name, "cuda"] != stats[name, "torch"] or stats[name, "cuda"][0] <= 0:
            raise AssertionError(f"parity: {name} spec counters {stats[name, 'cuda']} vs "
                                 f"{stats[name, 'torch']}")
    # the target as its own draft accepts every draft token whose target
    # position lies inside the slot's pages: whole steps accept everything
    # (a slot near the end of its budget also drafts past its last page,
    # where the target reads the shared sentinel page, and those drafts are
    # counted as proposed too)
    if all_accepted["self-draft", "cuda"] == 0:
        raise AssertionError(f"parity: self-draft never accepted a whole step "
                             f"({stats['self-draft', 'cuda']})")
    log("parity speculation (2 layers, full width, fp32): " + "; ".join(
        f"{n} rounds/accepted/drafted {stats[n, 'cuda']}, steps accepting every draft "
        f"{all_accepted[n, 'cuda']}" for n in ("draft", "ngram", "self-draft"))
        + "; streams equal cuda vs torch and to plain greedy")


def _dense_target_parity(cfg, params):
    """The dense target layout (kv_page_size=0) at 2 layers, full width,
    fp32, under chunked and monolithic prefill, plain, draft-paired and
    n-gram: equal streams and counters with impl="cuda" and "torch", the
    speculating streams equal to the plain greedy ones; and the paged engine
    with monolithic prefill, whose radix hits prefill only the suffix (the
    paged verify kernel over a bucket of up to 64 rows)."""
    import numpy as np
    import torch

    from repro_torch.configs import SpecDecodeConfig, draft_config
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import InferenceEngine

    dcfg = draft_config(cfg)
    dparams = T.init_params(dcfg, torch.Generator(device="cuda").manual_seed(1))
    pairings = {
        "plain": {},
        "draft": dict(draft_cfg=dcfg, draft_params=dparams,
                      spec=SpecDecodeConfig(proposer="draft")),
        "ngram": dict(spec=SpecDecodeConfig(proposer="ngram")),
    }
    prompts = _prompts(np.random.default_rng(1), 6, 24, 80, cfg.vocab_size,
                       shared_prefix=32, shared_idx=(0, 5))
    report = []
    for layout, kw in (("dense chunked", dict(kv_page_size=0)),
                       ("dense monolithic", dict(kv_page_size=0, prefill_chunk=0)),
                       ("paged monolithic", dict(prefill_chunk=0))):
        for name, pkw in pairings.items():
            if layout == "paged monolithic" and name != "plain":
                continue
            res = {}
            for impl in ("cuda", "torch"):
                eng = InferenceEngine(cfg, params, max_slots=4, max_seq=256,
                                      compute_dtype=torch.float32, decode_impl=impl,
                                      **kw, **pkw)
                reqs, _ = _serve(eng, prompts, max_new=12)
                res[impl] = ([list(r.output_tokens) for r in reqs],
                             (eng.spec_rounds, eng.spec_accepted, eng.spec_drafted,
                              eng.prefill_skipped_tokens))
            if res["cuda"] != res["torch"]:
                raise AssertionError(f"parity: {layout} {name} streams or counters differ "
                                     f"(cuda vs torch): {res['cuda'][1]} vs {res['torch'][1]}")
            if name == "plain":
                plain = res["cuda"][0]
            elif res["cuda"][0] != plain or res["cuda"][1][0] <= 0:
                raise AssertionError(f"parity: {layout} {name} streams differ from plain "
                                     f"greedy or no spec round ran ({res['cuda'][1]})")
            report.append(f"{layout} {name} (rounds/accepted/drafted/prefix-skipped "
                          f"{res['cuda'][1]})")
    if not res["cuda"][1][3]:
        raise AssertionError("parity: the paged monolithic engine had no radix hit")
    log("parity dense target and monolithic prefill (2 layers, full width, fp32): "
        + "; ".join(report) + "; streams equal cuda vs torch and to plain greedy")
    del dparams


def _ssm_parity():
    """falcon-mamba-7b at 2 layers, full width, fp32: the engine (dense
    state rows, monolithic dt-masked bucket prefill) gives equal streams
    with impl="cuda" and "torch", and its final conv and SSM states agree
    within SSM_RTOL of their largest value."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import InferenceEngine

    cfg = dataclasses.replace(configs.get_config("falcon-mamba-7b"), num_layers=2)
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    prompts = _prompts(np.random.default_rng(1), 6, 24, 80, cfg.vocab_size, 0, ())
    res = {}
    for impl in ("cuda", "torch"):
        eng = InferenceEngine(cfg, params, max_slots=4, max_seq=256,
                              compute_dtype=torch.float32, decode_impl=impl)
        reqs, _ = _serve(eng, prompts, max_new=12)
        res[impl] = ([list(r.output_tokens) for r in reqs],
                     {k: t.clone() for k, t in eng.cache["layers"].items()})
    if res["cuda"][0] != res["torch"][0]:
        raise AssertionError("parity: falcon-mamba streams differ (cuda vs torch)")
    errs = {k: ((res["cuda"][1][k] - r).abs().max() / r.abs().max()).item()
            for k, r in res["torch"][1].items()}
    log(f"parity falcon-mamba (2 layers, full width, fp32): {len(prompts)} requests, streams "
        f"equal; final state max err / max|state|: " + ", ".join(
            f"{k} {e:.2e}" for k, e in errs.items()) + f" (tol {SSM_RTOL:g})")
    if not max(errs.values()) <= SSM_RTOL:
        raise AssertionError(f"parity: falcon-mamba states differ by {errs}")
    del params, res


# ---------------------------------------------------------------------------
# 5. serve
# ---------------------------------------------------------------------------


def phase_serve():
    """qwen3-1.7b at full depth, bf16, 16 requests through EngineCore.
    Returns the kernel launch counts of the serving run."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import InferenceEngine
    from repro_torch.tree import tree_leaves

    gc.collect()  # the collocated phase's training state and engines
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = configs.get_config("qwen3-1.7b")
    t0 = time.monotonic()
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                           dtype=torch.bfloat16)
    t_start = time.monotonic()
    engine = InferenceEngine(cfg, params, max_slots=8, max_seq=512,
                             clock=lambda: time.monotonic() - t_start)
    torch.cuda.synchronize()
    log(f"serve: weights {sum(p.numel() for p in tree_leaves(params)) / 1e9:.3f} B params bf16, "
        f"KV pool {engine.kv_cache_bytes() / 1e9:.3f} GB, set-up {time.monotonic() - t0:.1f}s")
    prompts = _prompts(np.random.default_rng(2), 16, 24, 136, cfg.vocab_size,
                       shared_prefix=64, shared_idx=(0, 13, 14, 15))
    max_new = 32
    ops.reset_launch_counts()
    reqs, secs = _serve(engine, prompts, max_new)
    counts = ops.launch_counts()
    m = engine.obs.metrics
    for r in reqs:
        if r.finish_reason != "length" or len(r.output_tokens) != max_new:
            raise AssertionError(f"serve: request {r.request_id} ended "
                                 f"{r.finish_reason} with {len(r.output_tokens)} tokens")
        if not all(0 <= t < cfg.vocab_size for t in r.output_tokens):
            raise AssertionError("serve: token id out of the vocabulary")
    _require_launches("serve", counts, SERVE_KERNELS)
    bodies = _require_tc_bodies("serve", counts)
    graphs = _decode_graph_launches("serve", engine, cfg)
    tokens = sum(len(r.output_tokens) for r in reqs)
    ttft = m.histogram("core/online_ttft_s")
    lat = m.histogram("core/online_latency_s")
    log(f"serve: {len(reqs)} requests, prompts {min(map(len, prompts))}-"
        f"{max(map(len, prompts))} tokens ({sum(map(len, prompts))} total), "
        f"{tokens} new tokens in {secs:.3f}s = {tokens / secs:.1f} tok/s; "
        f"TTFT p50 {ttft.percentile(50) * 1e3:.1f} ms p95 {ttft.percentile(95) * 1e3:.1f} ms; "
        f"latency p50 {lat.percentile(50) * 1e3:.1f} ms p95 {lat.percentile(95) * 1e3:.1f} ms; "
        f"prefix-skipped {engine.prefill_skipped_tokens} tokens; "
        f"peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    log(f"serve: the decode graphs captured {graphs} paged decode launches (k: launches, "
        f"one a layer and step; every replay launches them again)")
    log(f"serve launches: {json.dumps(counts)} "
        f"(per generated token: " + ", ".join(
            f"{k} {v['cuda'] / tokens:.2f}" for k, v in counts.items()) + "); "
        f"bodies {json.dumps(bodies)}")
    _profile_serve(engine, cfg)
    return {name: c["cuda"] for name, c in counts.items()}


def _decode_graph_launches(phase, engine, cfg):
    """The paged decode launches each of the engine's decode graphs captured
    (``DecodeGraph.launches``): one a layer and step of its k.  Raises if
    the engine replayed no graph or a graph captured another count."""
    graphs = {k: g.launches["paged_decode_attention"] for k, g in engine._decode_graphs.items()}
    if not graphs or any(n != cfg.num_layers * k for k, n in graphs.items()):
        raise AssertionError(f"{phase}: decode graphs captured {graphs} paged decode "
                             f"launches ({cfg.num_layers} a step expected)")
    return graphs


def _busy_and_top(prof):
    """Device busy seconds (union of kernel intervals), kernel count and
    device seconds by kernel name, from a ``torch.profiler`` run; None
    when the profiler saw no device time."""
    import torch

    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            t0, t1 = e.time_range.start, e.time_range.end
            spans.append((t0, t1))
            by_name[e.name] = by_name.get(e.name, 0.0) + (t1 - t0) / 1e6
    if not spans:
        return None
    spans.sort()
    busy, end = 0.0, -math.inf
    for t0, t1 in spans:
        if t1 > end:
            busy += t1 - max(t0, end)
            end = t1
    return busy / 1e6, len(spans), by_name


def _profile_serve(engine, cfg, label="serve", kernel=None):
    """Where the time goes: a second, smaller serving round under
    ``torch.profiler`` -- the device's busy share of the wall time (union of
    kernel intervals) and the kernels that took it, and the launches and
    device time of the kernels whose name holds ``kernel``.  The profiler
    slows the host, so the share is a lower bound for the unprofiled run."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    prompts = _prompts(np.random.default_rng(3), 8, 48, 96, cfg.vocab_size, 0, ())
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        reqs, secs = _serve(engine, prompts, 16)
    got = _busy_and_top(prof)
    if got is None:
        log(f"{label} profile: the profiler saw no device time (not measured)")
        return
    busy_s, n, by_name = got
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    log(f"{label} profile ({len(reqs)} requests, {sum(len(r.output_tokens) for r in reqs)} "
        f"tokens, profiler on): wall {secs:.3f}s, device busy {busy_s:.3f}s "
        f"({100 * busy_s / secs:.1f}%), {n} kernels; top: " + "; ".join(
            f"{name[:60]} {sec * 1e3:.1f}ms" for name, sec in top))
    if kernel is not None:
        ms = [(e.time_range.end - e.time_range.start) / 1e3 for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.name]
        log(f"{label} profile: {len(ms)} {kernel} launches, {sum(ms):.3f} ms of device time")


# ---------------------------------------------------------------------------
# 6. spec serve
# ---------------------------------------------------------------------------


def _spec_engine(cfg, params, **kw):
    """``cfg`` (qwen3-1.7b, moonshot-v1-16b-a3b) paired with its draft model
    (seeded init, bf16), routing between the draft and the n-gram lookup
    per quantum."""
    import torch

    from repro_torch.configs import SpecDecodeConfig, draft_config
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import InferenceEngine

    spec = SpecDecodeConfig(proposer="auto")
    dcfg = draft_config(cfg, spec)
    dparams = T.init_params(dcfg, torch.Generator(device="cuda").manual_seed(1),
                            dtype=torch.bfloat16)
    return InferenceEngine(cfg, params, max_slots=8, max_seq=512, draft_cfg=dcfg,
                           draft_params=dparams, spec=spec, **kw)


def phase_spec_serve():
    """qwen3-1.7b at full depth, bf16, paired with its 1-layer draft,
    ``proposer="auto"``: the same 16 requests as the serve phase through
    EngineCore.  Returns the kernel launch counts of the run."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = configs.get_config("qwen3-1.7b")
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                           dtype=torch.bfloat16)
    t_start = time.monotonic()
    engine = _spec_engine(cfg, params, clock=lambda: time.monotonic() - t_start)
    prompts = _prompts(np.random.default_rng(2), 16, 24, 136, cfg.vocab_size,
                       shared_prefix=64, shared_idx=(0, 13, 14, 15))
    max_new = 32
    ops.reset_launch_counts()
    reqs, secs = _serve(engine, prompts, max_new)
    counts = ops.launch_counts()
    for r in reqs:
        if r.finish_reason != "length" or len(r.output_tokens) != max_new:
            raise AssertionError(f"spec serve: request {r.request_id} ended "
                                 f"{r.finish_reason} with {len(r.output_tokens)} tokens")
        if not all(0 <= t < cfg.vocab_size for t in r.output_tokens):
            raise AssertionError("spec serve: token id out of the vocabulary")
    m = engine.obs.metrics
    per = {}
    for name in ("draft", "ngram"):
        rounds = m.counter(f"spec/proposer/rounds/{name}").value
        if rounds <= 0:
            raise AssertionError(f"spec serve: the router ran no {name} round")
        per[name] = (rounds, m.counter(f"spec/proposer/accepted/{name}").value,
                     m.counter(f"spec/proposer/proposed/{name}").value)
    _require_launches("spec serve", counts, SPEC_KERNELS + ("paged_prefill_attention",))
    bodies = _require_tc_bodies("spec serve", counts)
    tokens = sum(len(r.output_tokens) for r in reqs)
    ttft = m.histogram("core/online_ttft_s")
    lat = m.histogram("core/online_latency_s")
    log(f"spec serve: {len(reqs)} requests, {tokens} new tokens in {secs:.3f}s = "
        f"{tokens / secs:.1f} tok/s; TTFT p50 {ttft.percentile(50) * 1e3:.1f} ms p95 "
        f"{ttft.percentile(95) * 1e3:.1f} ms; latency p50 {lat.percentile(50) * 1e3:.1f} ms "
        f"p95 {lat.percentile(95) * 1e3:.1f} ms; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    fallbacks = m.counter("spec/proposer/no_match_fallbacks").value
    log(f"spec serve: spec rounds {engine.spec_rounds} + {fallbacks} plain fallback steps "
        f"(no n-gram match); tokens after the first per round or fallback step "
        f"{(tokens - len(reqs)) / (engine.spec_rounds + fallbacks):.3f} (all slots); "
        f"acceptance "
        f"{engine.spec_acceptance_rate:.4f}; per proposer (rounds, accepted, proposed): "
        f"{per}; router switches {m.counter('spec/proposer/router_switches').value}; "
        f"{_tree_graphs('spec serve', engine)}")
    log(f"spec serve launches: {json.dumps(counts)}; bodies {json.dumps(bodies)}")
    _profile_serve(engine, cfg, "spec serve")
    return {name: c["cuda"] for name, c in counts.items()}


# ---------------------------------------------------------------------------
# 7. dense target serve, 8. ssm serve
# ---------------------------------------------------------------------------


def phase_dense_target_serve():
    """qwen3-1.7b at full depth, bf16, on the dense target layout
    (``kv_page_size=0``), paired with its draft, ``proposer="auto"``: the
    spec serve phase's 16 requests, which must launch the dense decode,
    dense prefill, dense verify and dense tree verify kernels; then a short
    run with ``prefill_chunk=0``, whose monolithic prefill must launch the
    flash forward kernel.  Returns the kernel launch counts of the first
    run."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = configs.get_config("qwen3-1.7b")
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                           dtype=torch.bfloat16)
    t_start = time.monotonic()
    engine = _spec_engine(cfg, params, clock=lambda: time.monotonic() - t_start,
                          kv_page_size=0)
    prompts = _prompts(np.random.default_rng(2), 16, 24, 136, cfg.vocab_size,
                       shared_prefix=64, shared_idx=(0, 13, 14, 15))
    max_new = 32
    ops.reset_launch_counts()
    reqs, secs = _serve(engine, prompts, max_new)
    counts = ops.launch_counts()
    _check_finished("dense target serve", reqs, max_new, cfg)
    m = engine.obs.metrics
    for name in ("draft", "ngram"):
        if m.counter(f"spec/proposer/rounds/{name}").value <= 0:
            raise AssertionError(f"dense target serve: the router ran no {name} round")
    _require_launches("dense target serve", counts, DENSE_TARGET_KERNELS)
    bodies = _require_tc_bodies("dense target serve", counts)
    tokens = sum(len(r.output_tokens) for r in reqs)
    per = {n: tuple(m.counter(f"spec/proposer/{w}/{n}").value
                    for w in ("rounds", "accepted", "proposed")) for n in ("draft", "ngram")}
    log(f"dense target serve: {_serve_summary(m, reqs, tokens, secs)}; kv cache "
        f"{engine.kv_cache_bytes() / 1e9:.3f} GB; spec rounds {engine.spec_rounds}; per "
        f"proposer (rounds, accepted, proposed): {per}; "
        f"{_tree_graphs('dense target serve', engine)}")
    log(f"dense target serve launches: {json.dumps(counts)}; bodies {json.dumps(bodies)}")
    _profile_serve(engine, cfg, "dense target serve")
    del engine
    gc.collect()
    engine = _spec_engine(cfg, params, kv_page_size=0, prefill_chunk=0)
    ops.reset_launch_counts()
    reqs, secs = _serve(engine, prompts[:4], 8)
    mono = ops.launch_counts()
    _check_finished("dense target serve, monolithic prefill", reqs, 8, cfg)
    _require_launches("dense target serve, monolithic prefill", mono,
                      ("flash_attention_fwd",))
    _require_tc_bodies("dense target serve, monolithic prefill", mono)
    log(f"dense target serve, monolithic prefill: {len(reqs)} requests in {secs:.3f}s; "
        f"launches {json.dumps({k: v['cuda'] for k, v in mono.items() if v['cuda']})}")
    return {name: c["cuda"] for name, c in counts.items()}


def _check_finished(phase, reqs, max_new, cfg):
    for r in reqs:
        if r.finish_reason != "length" or len(r.output_tokens) != max_new:
            raise AssertionError(f"{phase}: request {r.request_id} ended "
                                 f"{r.finish_reason} with {len(r.output_tokens)} tokens")
        if not all(0 <= t < cfg.vocab_size for t in r.output_tokens):
            raise AssertionError(f"{phase}: token id out of the vocabulary")


def _serve_summary(m, reqs, tokens, secs):
    import torch

    ttft = m.histogram("core/online_ttft_s")
    lat = m.histogram("core/online_latency_s")
    return (f"{len(reqs)} requests, {tokens} new tokens in {secs:.3f}s = "
            f"{tokens / secs:.1f} tok/s; TTFT p50 {ttft.percentile(50) * 1e3:.1f} ms p95 "
            f"{ttft.percentile(95) * 1e3:.1f} ms; latency p50 {lat.percentile(50) * 1e3:.1f} "
            f"ms p95 {lat.percentile(95) * 1e3:.1f} ms; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")


def phase_ssm_serve():
    """falcon-mamba-7b at full depth and width (64 layers, d_model 4096,
    d_inner 8192), bf16 weights made straight on the card, 8 slots, max_seq
    512: 16 ONLINE requests of 25-157 tokens, 32 new tokens each, through
    EngineCore on dense state rows with monolithic bucket prefill.  Every
    request must finish and the scan kernel must launch once per layer and
    admission, over the admission's whole bucket.  Returns the launch
    counts."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import InferenceEngine
    from repro_torch.tree import tree_leaves

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = configs.get_config("falcon-mamba-7b")
    t0 = time.monotonic()
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                           dtype=torch.bfloat16)
    t_start = time.monotonic()
    engine = InferenceEngine(cfg, params, max_slots=8, max_seq=512,
                             clock=lambda: time.monotonic() - t_start)
    del params
    torch.cuda.synchronize()
    log(f"ssm serve: weights {sum(p.numel() for p in tree_leaves(engine.params)) / 1e9:.3f} "
        f"B params bf16, state {engine.kv_cache_bytes() / 1e6:.1f} MB, set-up "
        f"{time.monotonic() - t0:.1f}s")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
               for n in rng.integers(25, 158, 16)]
    max_new = 32
    expected = cfg.num_layers * len(prompts)
    ops.reset_launch_counts()
    reqs, secs = _serve(engine, prompts, max_new)
    counts = ops.launch_counts()
    _check_finished("ssm serve", reqs, max_new, cfg)
    _require_launches("ssm serve", counts, SSM_KERNELS)
    if counts["ssm_scan"]["cuda"] != expected:
        raise AssertionError(f"ssm serve: {counts['ssm_scan']['cuda']} scan launches, "
                             f"{expected} expected (one a layer and admission)")
    tokens = sum(len(r.output_tokens) for r in reqs)
    log(f"ssm serve: prompts {min(map(len, prompts))}-{max(map(len, prompts))} tokens; "
        f"{_serve_summary(engine.obs.metrics, reqs, tokens, secs)}; scan launches "
        f"{counts['ssm_scan']['cuda']} (= {cfg.num_layers} layers x {len(prompts)} admissions)")
    _profile_serve(engine, cfg, "ssm serve", kernel="ssm_scan_kernel")
    return {name: c["cuda"] for name, c in counts.items()}


# ---------------------------------------------------------------------------
# 9. collocated
# ---------------------------------------------------------------------------


def phase_collocated():
    """qwen3-1.7b at full depth and width trains under SpecInFRuntime while
    a bf16 engine on the initial weights fills its bubbles.  Returns the
    kernel launch counts of the runtime's run, and what the chaos phase
    reuses: the engine weights, the trainer and its profile."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.configs import SpecInFConfig, TrainConfig
    from repro_torch.core import SpecInFRuntime, measure_dp_profile
    from repro_torch.data import SyntheticDataset
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.runtime import init_train_state, make_train_step
    from repro_torch.serving.core import Priority, SamplingParams
    from repro_torch.serving.engine import InferenceEngine, Request

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = configs.get_config("qwen3-1.7b")
    # optimiser defaults; the warmup and horizon fit a short run
    tcfg = TrainConfig(warmup_steps=2, total_steps=COLLOC_ITERS + 2)
    t0 = time.monotonic()
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                           dtype=getattr(torch, tcfg.param_dtype))
    engine = InferenceEngine(cfg, params, max_slots=8, max_seq=512)
    state = init_train_state(params)  # a copy: the engine serves the initial weights
    del params
    # the reference's compiled step: one CUDA graph, captured at its first call
    step = make_train_step(cfg, tcfg).jitted()
    ds = SyntheticDataset(cfg, seq_len=TRAIN_S, global_batch=TRAIN_B, seed=0)
    torch.cuda.synchronize()
    log(f"collocated: set-up {time.monotonic() - t0:.1f}s (fp32 params + AdamW "
        f"state, bf16 engine weights)")
    # the "dots" step before the graph's pool holds the step's activations:
    # its own and the "none" reference's would not fit beside it
    _dots_step(cfg, tcfg, state, ds)

    # the profile's units: the train step (its warm-up call captures the
    # graph; the timed call replays it) and the engine microstep (4 offline
    # slots running, as the backlog below fills them), measured here
    batches = (ds.next_batch() for _ in iter(int, 1))
    torch.cuda.reset_peak_memory_stats()
    profile, microstep_s = measure_dp_profile(cfg.name, step, state, batches, engine)
    if (step.graphs.captures, len(step.graphs.graphs)) != (1, 1):
        raise AssertionError(f"collocated: the train step's graph captured "
                             f"{step.graphs.captures} times")
    (graph,) = step.graphs.graphs.values()
    log(f"collocated: the train step replayed as one CUDA graph (jitted(); capture "
        f"{graph.prog.capture_s:.2f}s, pool {step.graphs.pool_bytes() / 1e9:.2f} GB, "
        f"hand-written kernels a replay {json.dumps({n: c for n, c in graph.prog.launches.items() if c})}, "
        f"peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB)")
    del graph
    compute_s = profile.compute_s
    spec_cfg = SpecInFConfig()
    log(f"collocated: train step {compute_s * 1e3:.1f} ms (B={TRAIN_B} x S={TRAIN_S} = "
        f"{TRAIN_B * TRAIN_S / compute_s:.0f} tokens/s), engine microstep "
        f"{microstep_s * 1e3:.1f} ms (4 slots; Algorithm-1 cap {spec_cfg.upper_limit:g} "
        f"tokens = {spec_cfg.upper_limit / (microstep_s * 1e3):.2f} microsteps); dp profile: "
        f"iteration {profile.iteration_s * 1e3:.1f} ms, bubbles "
        f"{profile.bubble_fraction:.1%}, longest {profile.max_bubble_s * 1e3:.1f} ms")

    rng = np.random.default_rng(5)
    for n in (24, 48, 80, 130):  # offline backlog
        engine.core.submit(rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                           SamplingParams(max_new_tokens=256), priority=Priority.OFFLINE)
    online = [Request(prompt=rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                      max_new_tokens=8, arrival_time=t, online=True)
              for n, t in ((20, 0.0), (40, profile.iteration_s), (64, 2 * profile.iteration_s))]
    train_ms = []

    def timed_step(st, batch):
        t = time.monotonic()
        out = step(st, batch)
        torch.cuda.synchronize()
        train_ms.append((time.monotonic() - t) * 1e3)
        return out

    rt = SpecInFRuntime(train_step=timed_step, train_state=state, batch_iter=batches,
                        profile=profile, engine=engine, online_requests=online,
                        cfg=spec_cfg, decode_microstep_s=microstep_s)
    ops.reset_launch_counts()
    t0 = time.monotonic()
    m = rt.run(COLLOC_ITERS)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts = ops.launch_counts()

    losses = m.train_losses
    if not (len(losses) == COLLOC_ITERS and np.isfinite(losses).all()
            and losses[-1] < losses[0]):
        raise AssertionError(f"collocated: losses {losses} (finite and falling expected)")
    if m.offline_tokens_generated <= 0:
        raise AssertionError("collocated: no offline tokens were filled into the bubbles")
    if m.online_served != len(online):
        raise AssertionError(f"collocated: {m.online_served} of {len(online)} online "
                             f"requests finished")
    _require_launches("collocated", counts, SERVE_KERNELS + TRAIN_KERNELS)
    bodies = _require_tc_bodies("collocated", counts)
    online_tokens = m.obs.metrics.counter("core/generated_tokens/online").value
    total = sum(m.phase_counts.values())
    shares = {k: round(v / total, 4) for k, v in sorted(m.phase_counts.items())}
    step_ms = float(np.mean(train_ms))
    log(f"collocated: {COLLOC_ITERS} iterations in {wall:.2f}s wall "
        f"({sum(train_ms) / 1e3:.2f}s training, {wall - sum(train_ms) / 1e3:.2f}s filling "
        f"and control); loss {losses[0]:.4f} -> {losses[-1]:.4f}; train step "
        f"{step_ms:.1f} ms mean = {TRAIN_B * TRAIN_S / step_ms * 1e3:.0f} training tokens/s "
        f"(steps {', '.join(f'{t:.1f}' for t in train_ms)} ms; allocator retries "
        f"{torch.cuda.memory_stats().get('num_alloc_retries', 0)}, reserved "
        f"{torch.cuda.memory_reserved() / 1e9:.2f} GB)")
    log(f"collocated: filled {m.offline_tokens_generated} offline tokens in "
        f"{m.offline_microsteps} microsteps and {online_tokens} online tokens "
        f"({m.online_served} requests, TTFT p95 {m.p95_ttft_s() * 1e3:.1f} ms, latency "
        f"p95 {m.p95_latency_s() * 1e3:.1f} ms virtual); {m.preemptions} preemptions; "
        f"virtual time {m.virtual_time_s:.3f}s; Algorithm-1 phase shares {shares}; "
        f"peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    log(f"collocated launches: {json.dumps(counts)} (per train step: " + ", ".join(
        f"{k} {counts[k]['cuda'] / COLLOC_ITERS:.1f}"
        for k in ("flash_attention_fwd", "flash_attention_bwd")) + "); bodies "
        f"{json.dumps(bodies)}")
    eparams = engine.params  # the initial weights, bf16
    del engine, rt
    _spec_collocated(cfg, eparams, timed_step, state, batches, profile, microstep_s)
    colloc = dict(cfg=cfg, eparams=eparams, step=timed_step, state=state, batches=batches,
                  profile=profile, microstep_s=microstep_s)
    return {name: c["cuda"] for name, c in counts.items()}, colloc


def _spec_collocated(cfg, params, step, state, batches, profile, microstep_s):
    """The training run goes on for SPEC_COLLOC_ITERS iterations with a
    speculating engine (the initial weights paired with the draft model)
    filling its bubbles under SpecInFRuntime's gamma controller, at the same
    Algorithm-1 cap."""
    import numpy as np
    import torch

    from repro_torch.configs import SpecInFConfig
    from repro_torch.core import SpecInFRuntime
    from repro_torch.kernels import ops
    from repro_torch.serving.core import Priority, SamplingParams
    from repro_torch.serving.engine import Request

    gc.collect()
    torch.cuda.empty_cache()
    engine = _spec_engine(cfg, params)
    rng = np.random.default_rng(6)
    for n in (24, 48, 80, 130):  # offline backlog
        engine.core.submit(rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                           SamplingParams(max_new_tokens=256), priority=Priority.OFFLINE)
    online = [Request(prompt=rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                      max_new_tokens=8, arrival_time=t, online=True)
              for n, t in ((20, 0.0), (40, profile.iteration_s))]
    rt = SpecInFRuntime(train_step=step, train_state=state, batch_iter=batches,
                        profile=profile, engine=engine, online_requests=online,
                        cfg=SpecInFConfig(),
                        decode_microstep_s=microstep_s)
    ops.reset_launch_counts()
    t0 = time.monotonic()
    m = rt.run(SPEC_COLLOC_ITERS)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts = ops.launch_counts()
    if not np.isfinite(m.train_losses).all():
        raise AssertionError(f"spec collocated: losses {m.train_losses}")
    if m.online_served != len(online):
        raise AssertionError(
            f"spec collocated: {m.online_served} of {len(online)} online requests "
            f"finished (microstep {microstep_s * 1e3:.1f} ms, longest bubble "
            f"{profile.max_bubble_s * 1e3:.1f} ms: see ROADMAP C4)")
    if m.offline_tokens_generated <= 0 or m.spec_rounds <= 0:
        raise AssertionError(f"spec collocated: {m.offline_tokens_generated} offline "
                             f"tokens, {m.spec_rounds} spec rounds")
    _require_launches("spec collocated", counts, TRAIN_KERNELS)
    bodies = _require_tc_bodies("spec collocated", counts)
    total = sum(m.phase_counts.values())
    shares = {k: round(v / total, 4) for k, v in sorted(m.phase_counts.items())}
    log(f"spec collocated: {SPEC_COLLOC_ITERS} iterations in {wall:.2f}s wall; loss "
        f"{m.train_losses[0]:.4f} -> {m.train_losses[-1]:.4f}; {m.spec_rounds} spec rounds "
        f"(gamma controller acceptance {rt.gamma_ctrl.acceptance:.4f}), "
        f"{m.offline_tokens_generated} offline tokens in {m.offline_microsteps} "
        f"microsteps, {m.online_served} online requests (TTFT p95 "
        f"{m.p95_ttft_s() * 1e3:.1f} ms virtual); virtual time {m.virtual_time_s:.3f}s; "
        f"phase shares {shares}")
    log(f"spec collocated launches: {json.dumps(counts)}; bodies {json.dumps(bodies)}")


def _dots_step(cfg, tcfg, state, ds):
    """One more full-depth train step under ``remat_policy="dots"``: its
    loss and gradient norm must equal those of ``"none"`` on the same
    weights and batch (within LOSS_RTOL_BF16), and each layer's flash
    forward must launch twice (again in the backward's recompute)."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.runtime import make_train_step
    from repro_torch.tree import tree_leaves

    batch = ds.next_batch()
    params = state["params"]
    inputs = torch.as_tensor(batch["inputs"], device="cuda")
    labels = torch.as_tensor(batch["labels"], device="cuda")
    torch.cuda.reset_peak_memory_stats()
    loss, _ = T.lm_loss(cfg, params, inputs, labels, remat_policy="none",
                        compute_dtype=getattr(torch, tcfg.compute_dtype))
    grads = torch.autograd.grad(loss, tree_leaves(params))
    ref_loss = loss.item()
    ref_gnorm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads)).item()
    none_peak = torch.cuda.max_memory_allocated() / 1e9
    del loss, grads
    step = make_train_step(cfg, dataclasses.replace(tcfg, remat_policy="dots"))
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.monotonic()
    _, metrics = step(state, batch)
    torch.cuda.synchronize()
    secs = time.monotonic() - t0
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    t0 = time.monotonic()  # a second step: the first may pay one-time costs
    step(state, ds.next_batch())
    torch.cuda.synchronize()
    secs2 = time.monotonic() - t0
    loss, gnorm = metrics["loss"].item(), metrics["grad_norm"].item()
    fwd, bwd = counts["flash_attention_fwd"]["cuda"], counts["flash_attention_bwd"]["cuda"]
    log(f"dots train step: {secs * 1e3:.1f} ms (a second one {secs2 * 1e3:.1f} ms; "
        f"allocator retries {torch.cuda.memory_stats().get('num_alloc_retries', 0)}), loss "
        f"{loss:.6f} vs none {ref_loss:.6f}, grad norm {gnorm:.6f} vs none {ref_gnorm:.6f} "
        f"(rtol {LOSS_RTOL_BF16:g}); flash forward {fwd}, backward {bwd} launches; peak "
        f"device memory {peak:.2f} GB (none, loss and gradients only: {none_peak:.2f} GB)")
    _require_launches("dots train step", counts, TRAIN_KERNELS)
    layers = cfg.num_layers
    if (fwd, bwd) != (2 * layers, layers):
        raise AssertionError(f"dots train step: flash launches {fwd} / {bwd}, expected "
                             f"{2 * layers} / {layers}")
    for name, got, ref in (("loss", loss, ref_loss), ("grad norm", gnorm, ref_gnorm)):
        if not abs(got - ref) <= LOSS_RTOL_BF16 * abs(ref):
            raise AssertionError(f"dots train step: {name} {got} vs {ref} under 'none'")


# ---------------------------------------------------------------------------
# 6. chaos
# ---------------------------------------------------------------------------

#: the serving fault points, armed together (``scripts/check_chaos.py``'s
#: sweep, at twice its rate so one seed fires every point)
CHAOS_SPECS = (
    ("engine/nan_logits", {"probability": 0.1, "max_fires": 3}),
    ("pool/alloc_fail", {"probability": 0.1, "after": 2, "max_fires": 3}),
    ("core/revoke_mid_quantum", {"probability": 0.1, "max_fires": 3}),
    ("core/step_overrun", {"probability": 0.1, "max_fires": 3}),
)
CHAOS_SEED = 1
CHAOS_STEP_S = 0.002  # virtual seconds a microstep-equivalent costs
CHAOS_CLEAN = ("length", "stop")


def _injector(specs, seed=CHAOS_SEED):
    from repro_torch.resilience import FaultInjector, FaultSpec

    return FaultInjector(seed=seed, specs=[FaultSpec(p, **kw) for p, kw in specs])


def _chaos_submit(core, vocab, seed, n_off, n_on, off_new, on_new, lo, hi):
    """``n_off`` OFFLINE requests at t = 0 and ``n_on`` ONLINE ones arriving
    10 ms apart on average (virtual), prompts of ``lo``..``hi`` tokens."""
    import numpy as np

    from repro_torch.serving.core import Priority, SamplingParams

    rng = np.random.default_rng(seed)
    reqs = [core.submit(rng.integers(0, vocab, int(rng.integers(lo, hi + 1))),
                        SamplingParams(max_new_tokens=off_new),
                        priority=Priority.OFFLINE, arrival_time=0.0)
            for _ in range(n_off)]
    for t in np.cumsum(rng.exponential(0.01, n_on)):
        reqs.append(core.submit(rng.integers(0, vocab, int(rng.integers(lo, hi + 1))),
                                SamplingParams(max_new_tokens=on_new, deadline_s=5.0),
                                priority=Priority.ONLINE, arrival_time=float(t)))
    return reqs


def _chaos_drain(core, vnow, token_budget):
    """Step the core on the virtual clock until every request finishes, each
    grant revocable (a fresh signal, re-checked every 2 microsteps)."""
    from repro_torch.serving.core import Grant, RevocationSignal

    quanta = 0
    while core.has_unfinished:
        quanta += 1
        if quanta > 5000:
            raise AssertionError("chaos: the drain made no progress (containment hang)")
        base = vnow[0]
        out = core.step(Grant(
            now=base, token_budget=token_budget, revocation=RevocationSignal(),
            revoke_check_steps=2,
            advance_clock=lambda steps, b=base: vnow.__setitem__(0, b + steps * CHAOS_STEP_S)))
        if out.cost_steps == 0 and not out.admitted:
            vnow[0] += CHAOS_STEP_S
    return quanta


def _chaos_checks(label, engine, reqs, base, inj, exact=True):
    """What a chaos drain must show: every request terminal, every clean
    finish equal to the fault-free run's (``exact``; else only counted),
    one quarantine per ``engine/nan_logits`` fire, every KV row no slot
    holds finite, attribution telescoping to 1e-6 with no dropped event.
    Returns (clean finishes equal to the fault-free run, clean finishes)."""
    import torch

    m = engine.obs.metrics
    if not all(r.state.finished for r in reqs):
        raise AssertionError(f"{label}: a request never reached a terminal state")
    clean = [(r, b) for r, b in zip(reqs, base) if r.finish_reason in CHAOS_CLEAN]
    same = sum(r.output_tokens == b.output_tokens and r.finish_reason == b.finish_reason
               for r, b in clean)
    if exact and same != len(clean):
        raise AssertionError(f"{label}: {len(clean) - same} clean finishes differ from the "
                             f"fault-free run")
    fires = inj.fires.get("engine/nan_logits", 0)
    quarantines = m.counter("fault/nan_quarantines").value
    if fires == 0 or quarantines != fires:
        raise AssertionError(f"{label}: {quarantines} NaN quarantines for {fires} fires")
    layers = engine.cache["layers"]
    if engine.paged:
        free = [p for p in range(engine.pool.num_pages) if engine.pool.refcount[p] == 0]
        idx = torch.tensor(free, device="cuda")
        rows = [layers["k"][:, idx], layers["v"][:, idx]]
    else:
        rows = [layers["k"], layers["v"]]  # every slot is free after the drain
    if not all(torch.isfinite(t).all() for t in rows):
        raise AssertionError(f"{label}: a free KV page / row holds a non-finite value")
    tr = engine.obs.tracer
    resid = max((abs(ra.total - (ra.finish_time - ra.arrival_time))
                 for ra in tr.attribution().values() if ra.finish_time is not None),
                default=0.0)
    if tr.dropped or not resid <= 1e-6:
        raise AssertionError(f"{label}: tracer dropped {tr.dropped}, attribution residual "
                             f"{resid}")
    return same, len(clean), resid


def _timed_quarantines(engine, inj):
    """Wrap the engine so each quarantine's cost is recorded: (from the
    poisoning before the fused dispatch to the request's requeue, the scrub,
    evict and requeue alone), in ms, the device synchronised at each end."""
    import torch

    costs, poisoned = [], []
    inject, quarantine = engine._maybe_inject_nan, engine._quarantine_slot

    def timed_inject():
        fired = inj.fires.get("engine/nan_logits", 0)
        t = time.monotonic()
        inject()
        if inj.fires.get("engine/nan_logits", 0) > fired:
            poisoned.append(t)

    def timed_quarantine(i):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        req = quarantine(i)
        torch.cuda.synchronize()
        t1 = time.monotonic()
        costs.append(((t1 - poisoned[-1]) * 1e3, (t1 - t0) * 1e3))
        return req

    engine._maybe_inject_nan, engine._quarantine_slot = timed_inject, timed_quarantine
    return costs


def phase_chaos(colloc):
    """Failure containment and crash recovery on the card (the reference's
    ``scripts/check_chaos.py`` sweeps), before any profiler session.

    fp32, the 2-layer full-width qwen3-1.7b of phase 4: a mixed ONLINE /
    OFFLINE drain through ``EngineCore.step()`` on a virtual clock with the
    NaN, allocator, revocation and overrun points armed, on the paged layout
    (graph-replayed decode), the dense layout and the paged layout with the
    draft pairing; every clean finish byte-identical to the fault-free cuda
    run.  Then the recovery sweep (``process/kill`` and a journal; each kill
    cuts the journal to its fsynced prefix and replays it into a fresh
    engine) on both layouts: one durable finish a request, streams equal to
    the uninterrupted run's; and a snapshot round trip warming a fresh
    engine's radix cache.  bf16, qwen3-1.7b at full depth and width: one
    paged chaos sweep (clean finishes equal to the fault-free bf16 run
    counted, not asserted: a re-prefill rounds differently from decode),
    its fault-free run journaled, the snapshot timed; then phase 5's trainer
    under ``SpecInFRuntime`` with ``runtime/early_resume`` armed and
    ``revocation_check_steps=1``."""
    import tempfile

    import torch

    from repro_torch import configs
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import SpecDecodeConfig, draft_config
    from repro_torch.models import transformer as T
    from repro_torch.resilience import (
        EngineSnapshot,
        FaultInjector,
        FaultSpec,
        ProcessKilled,
        RequestJournal,
        read_journal,
    )
    from repro_torch.serving.engine import InferenceEngine

    cfg = dataclasses.replace(configs.get_config("qwen3-1.7b"), num_layers=2)
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    spec = SpecDecodeConfig(mode="greedy")
    dcfg = draft_config(cfg, spec)
    dparams = T.init_params(dcfg, torch.Generator(device="cuda").manual_seed(1))
    tmp = tempfile.TemporaryDirectory()

    def engine(vnow, page, draft=False, inj=None):
        kw = dict(draft_cfg=dcfg, draft_params=dparams, spec=spec) if draft else {}
        return InferenceEngine(cfg, params, max_slots=4, max_seq=256,
                               compute_dtype=torch.float32, clock=lambda: vnow[0],
                               kv_page_size=page, fault_injector=inj, **kw)

    def serve(page, draft=False, inj=None, eng=None):
        vnow = [0.0]
        eng = eng or engine(vnow, page, draft, inj)
        eng.clock = lambda: vnow[0]
        eng.core.fault_backoff_s = 0.0  # virtual clock: retry at once
        reqs = _chaos_submit(eng.core, cfg.vocab_size, 3, 4, 6, 24, 8, 17, 90)
        _chaos_drain(eng.core, vnow, token_budget=64)
        return eng, reqs

    t0 = time.monotonic()
    bases = {}
    for page, draft in ((16, False), (0, False), (16, True)):
        label = f"chaos fp32 {'paged' if page else 'dense'}{' + draft' if draft else ''}"
        _, base = serve(page, draft)
        if not all(b.finish_reason in CHAOS_CLEAN for b in base):
            raise AssertionError(f"{label}: the fault-free run did not finish every request")
        bases[(page, draft)] = base
        inj = _injector(CHAOS_SPECS)
        eng, reqs = serve(page, draft, inj)
        same, clean, resid = _chaos_checks(label, eng, reqs, base, inj)
        graphs = sorted(eng._decode_graphs)
        if page and not draft:
            _decode_graph_launches(label, eng, cfg)
        faults = {k: v["value"] for k, v in eng.obs.metrics.snapshot().items()
                  if k.startswith("fault/") and "value" in v}
        log(f"{label}: fires {dict(inj.fires)}; {json.dumps(faults)}; clean finishes "
            f"{same}/{clean} equal to the fault-free run, {len(reqs) - clean} not clean; "
            f"attribution residual {resid:.1e}; decode graphs captured for k in {graphs}")

    # recovery: kill -> cut the journal to its fsynced prefix -> replay
    recover_ms = []
    for page in (16, 0):
        label = f"recovery fp32 {'paged' if page else 'dense'}"
        path = os.path.join(tmp.name, f"journal_{page}.jsonl")
        inj = FaultInjector(seed=CHAOS_SEED, specs=(
            FaultSpec("process/kill", probability=0.05, max_fires=3),))
        restarts, rid0 = 0, None
        while True:
            vnow = [0.0]
            eng = engine(vnow, page, inj=inj)
            eng.core.fault_backoff_s = 0.0
            journal = RequestJournal(path, fsync_interval=4)
            report = journal.recover_into(eng.core)
            recover_ms.append(report.duration_s * 1e3)
            journal.attach(eng.core)
            if rid0 is None:
                rid0 = _chaos_submit(eng.core, cfg.vocab_size, 3, 4, 6, 24, 8, 17, 90
                                     )[0].request_id
            try:
                _chaos_drain(eng.core, vnow, token_budget=64)
            except ProcessKilled:
                journal.crash()
                restarts += 1
                if restarts > 10:
                    raise AssertionError(f"{label}: the kill / restore loop did not converge")
                continue
            journal.close()
            break
        toks, fins = {}, {}
        for rec in read_journal(path)[0]:
            if rec["k"] == "delta":
                cur = toks.setdefault(rec["rid"] - rid0, [])
                if rec["tot"] == len(cur) + len(rec["tok"]):
                    cur.extend(rec["tok"])
            elif rec["k"] == "fin":
                fins.setdefault(rec["rid"] - rid0, []).append(rec["rsn"])
        base = bases[(page, False)]
        bad = [i for i, b in enumerate(base)
               if fins.get(i) != [b.finish_reason] or toks.get(i, []) != b.output_tokens]
        if inj.total_fires == 0 or bad:
            raise AssertionError(f"{label}: {inj.total_fires} kills; requests {bad} lost, "
                                 f"duplicated or diverged")
        log(f"{label}: {inj.total_fires} kills, {restarts} restarts; every request has one "
            f"durable finish equal to the uninterrupted run; recover_into "
            f"{', '.join(f'{t:.2f}' for t in recover_ms[-restarts - 1:])} ms")

    # snapshot: a fresh paged engine warmed from the radix cache
    eng, _ = serve(16)
    snap_dir = os.path.join(tmp.name, "snap_fp32")
    if not EngineSnapshot(eng, Checkpointer(snap_dir)).save():
        raise AssertionError("snapshot fp32: nothing to save")
    vnow = [0.0]
    warm = engine(vnow, 16)
    loaded = EngineSnapshot(warm, Checkpointer(snap_dir)).restore()
    _, reqs = serve(16, eng=warm)
    equal = [r.output_tokens for r in reqs] == [b.output_tokens for b in bases[(16, False)]]
    if not (loaded > 0 and warm.prefix_cache.hits > 0 and equal):
        raise AssertionError(f"snapshot fp32: {loaded} nodes loaded, {warm.prefix_cache.hits} "
                             f"radix hits, streams equal {equal}")
    log(f"snapshot fp32: {loaded} radix nodes restored, {warm.prefix_cache.hits} hits, "
        f"prefill skipped {warm.prefill_skipped_tokens} tokens, streams equal; fp32 sweeps "
        f"{time.monotonic() - t0:.1f}s")
    del eng, warm, params, dparams
    _chaos_full_depth(colloc, tmp.name)
    tmp.cleanup()


def _chaos_full_depth(colloc, tmpdir):
    """The bf16 full-depth part of ``phase_chaos``: phase 5's engine weights
    and trainer (``colloc``)."""
    import numpy as np
    import torch

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import SpecInFConfig
    from repro_torch.core import SpecInFRuntime
    from repro_torch.resilience import EngineSnapshot, RequestJournal
    from repro_torch.serving.core import Priority, SamplingParams
    from repro_torch.serving.engine import InferenceEngine

    cfg, eparams = colloc["cfg"], colloc["eparams"]
    gc.collect()
    torch.cuda.empty_cache()

    def serve(inj=None, journal=None, vnow=None):
        vnow = vnow if vnow is not None else [0.0]
        eng = InferenceEngine(cfg, eparams, max_slots=4, max_seq=512, clock=lambda: vnow[0],
                              fault_injector=inj)
        eng.core.fault_backoff_s = 0.0
        if journal is not None:
            journal.attach(eng.core)
        reqs = _chaos_submit(eng.core, cfg.vocab_size, 4, 4, 6, 32, 8, 24, 130)
        t0 = time.monotonic()
        _chaos_drain(eng.core, vnow, token_budget=64)
        torch.cuda.synchronize()
        return eng, reqs, time.monotonic() - t0

    # the fault-free run, journaled: appends and fsyncs per served token
    journal = RequestJournal(os.path.join(tmpdir, "journal_bf16.jsonl"), fsync_interval=8)
    spent = {"hooks": 0.0, "fsync": 0.0}

    def timed(name, fn):
        def wrapped(*a):
            t = time.monotonic()
            out = fn(*a)
            spent[name] += time.monotonic() - t
            return out
        return wrapped

    for hook in ("record_submit", "record_step", "record_finish"):
        setattr(journal, hook, timed("hooks", getattr(journal, hook)))
    journal.commit = timed("fsync", journal.commit)
    eng, base, secs = serve(journal=journal)
    journal.close()
    tokens = sum(len(r.output_tokens) for r in base)
    if not all(b.finish_reason in CHAOS_CLEAN for b in base):
        raise AssertionError("chaos bf16: the fault-free run did not finish every request")
    log(f"journal bf16 (fsync every 8 records): {journal.appends} appends, {journal.fsyncs} "
        f"fsyncs for {tokens} tokens = {journal.appends / tokens:.3f} appends, "
        f"{journal.fsyncs / tokens:.3f} fsyncs a token; journal hooks "
        f"{spent['hooks'] * 1e3:.2f} ms (fsyncs {spent['fsync'] * 1e3:.2f} ms) of the "
        f"{secs * 1e3:.1f} ms drain, {spent['hooks'] / tokens * 1e6:.1f} us a token")

    # snapshot of the full-depth radix cache: bytes, save and restore times
    snap_dir = os.path.join(tmpdir, "snap_bf16")
    t0 = time.monotonic()
    EngineSnapshot(eng, Checkpointer(snap_dir)).save()
    save_ms = (time.monotonic() - t0) * 1e3
    nbytes = sum(os.path.getsize(os.path.join(dp, f))
                 for dp, _, fs in os.walk(snap_dir) for f in fs)
    del eng
    warm = InferenceEngine(cfg, eparams, max_slots=4, max_seq=512)
    t0 = time.monotonic()
    loaded = EngineSnapshot(warm, Checkpointer(snap_dir)).restore()
    torch.cuda.synchronize()
    restore_ms = (time.monotonic() - t0) * 1e3
    if loaded <= 0:
        raise AssertionError("snapshot bf16: no radix node restored")
    log(f"snapshot bf16: {loaded} radix nodes, {nbytes / 1e6:.2f} MB on disk; save "
        f"{save_ms:.1f} ms, restore {restore_ms:.1f} ms")
    del warm

    # the chaos sweep: containment, quarantine cost, share of equal finishes
    inj = _injector(CHAOS_SPECS)
    vnow = [0.0]
    eng = InferenceEngine(cfg, eparams, max_slots=4, max_seq=512, clock=lambda: vnow[0],
                          fault_injector=inj)
    costs = _timed_quarantines(eng, inj)
    eng.core.fault_backoff_s = 0.0
    reqs = _chaos_submit(eng.core, cfg.vocab_size, 4, 4, 6, 32, 8, 24, 130)
    _chaos_drain(eng.core, vnow, token_budget=64)
    same, clean, resid = _chaos_checks("chaos bf16 paged", eng, reqs, base, inj, exact=False)
    faults = {k: v["value"] for k, v in eng.obs.metrics.snapshot().items()
              if k.startswith("fault/") and "value" in v}
    log(f"chaos bf16 paged ({cfg.num_layers} layers): fires {dict(inj.fires)}; {json.dumps(faults)}; "
        f"attribution residual {resid:.1e}; quarantine, poisoning to requeue "
        f"{', '.join(f'{a:.2f}' for a, _ in costs)} ms (scrub + evict + requeue "
        f"{', '.join(f'{b:.2f}' for _, b in costs)} ms); decode graphs for k in "
        f"{sorted(eng._decode_graphs)}")
    log(f"chaos bf16 share of clean finishes equal to the fault-free run: {same}/{clean} = "
        f"{same / max(clean, 1):.3f} (not asserted: a re-prefill in bf16 rounds otherwise "
        f"than the decode it replaces)")
    del eng

    # early resume under the runtime: phase 5's trainer, revocation_check_steps=1
    step, state, batches = colloc["step"], colloc["state"], colloc["batches"]
    profile, microstep_s = colloc["profile"], colloc["microstep_s"]
    iters = 3
    eng = InferenceEngine(cfg, eparams, max_slots=8, max_seq=512)
    rng = np.random.default_rng(7)
    for n in (24, 48, 80, 130):
        eng.core.submit(rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                        SamplingParams(max_new_tokens=256), priority=Priority.OFFLINE)
    # wall overrun: from the start of the sub-dispatch whose virtual span
    # crossed the resume instant (the quantum's start if none did) to the
    # return of the step, the device synchronised
    subs, wall_overrun = [], []
    decode, core_step = eng._drive_decode_loop, eng.core.step

    def timed_decode(k):
        subs.append((time.monotonic(), eng.clock()))  # the clock is at its end
        return decode(k)

    def timed_step(grant=None):
        subs.clear()
        t0 = time.monotonic()
        out = core_step(grant)
        sig = grant.revocation
        if sig is not None and grant.now < sig.revoke_at <= eng.clock():
            torch.cuda.synchronize()
            start = next((w for w, v in subs if v >= sig.revoke_at), t0)
            wall_overrun.append((time.monotonic() - start) * 1e3)
        return out

    eng._drive_decode_loop, eng.core.step = timed_decode, timed_step
    # every bubble resumes early: some instants fall inside a running quantum
    inj = _injector((("runtime/early_resume", {"probability": 1.0}),))
    rt = SpecInFRuntime(train_step=step, train_state=state, batch_iter=batches,
                        profile=profile, engine=eng,
                        cfg=SpecInFConfig(revocation_check_steps=1),
                        decode_microstep_s=microstep_s, faults=inj)
    m = rt.run(iters)
    baseline = SpecInFRuntime(train_step=lambda s, b: (s, {}), train_state=None,
                              batch_iter=iter(lambda: {}, None), profile=profile,
                              cfg=SpecInFConfig()).run(iters)
    reg = eng.obs.metrics
    resumes = reg.counter("fault/early_resume").value
    virtual = reg.histogram("fault/revocation_overrun_s").values()
    bound = 3 * microstep_s  # one sub-dispatch, and the monitor window's slack
    if not (resumes == inj.fires["runtime/early_resume"] >= 1
            and max(virtual, default=math.inf) <= bound
            and m.virtual_time_s == baseline.virtual_time_s
            and m.train_iterations == iters and np.isfinite(m.train_losses).all()):
        raise AssertionError(f"early resume: {resumes} resumes for {inj.fires} fires, "
                             f"virtual overruns {virtual} (bound {bound}), virtual time "
                             f"{m.virtual_time_s} vs baseline {baseline.virtual_time_s}")
    log(f"early resume ({cfg.num_layers} layers, bf16, {iters} iterations, revocation_check_steps=1): "
        f"{resumes} resumes; virtual overrun "
        f"{', '.join(f'{v * 1e3:.3f}' for v in virtual)} ms (bound {bound * 1e3:.2f} ms: "
        f"one sub-dispatch); virtual time {m.virtual_time_s:.6f} s = the no-serving "
        f"baseline; {len(wall_overrun)} of the resumes fell inside a running quantum, wall "
        f"overrun from revocation to yield [{', '.join(f'{w:.2f}' for w in wall_overrun)}] "
        f"ms (the others fell where no quantum ran; a fresh engine's first decode dispatch "
        f"also captures its decode graphs); {m.offline_tokens_generated} offline tokens "
        f"filled")


# ---------------------------------------------------------------------------
# 28. the sharing policies on the card's profile
# ---------------------------------------------------------------------------

#: simulated seconds of each timeline run (the reference tests' length)
POLICY_SIM_S = 30.0
#: the online service-time probe: one ONLINE request on an idle engine
SERVICE_PROMPT, SERVICE_NEW = 40, 8


def _sim_fields(res):
    """A ``SimResult``'s fields, NaN made comparable (a run serving no
    online request has NaN latencies)."""
    return {k: ("nan" if isinstance(v, float) and math.isnan(v) else v)
            for k, v in dataclasses.asdict(res).items()}


def phase_policies(colloc):
    """Phase 28: the reference's timeline simulator (``core.simulator``) runs
    MPS, TGS, Co-Exec, Exclusive and SpecInF over the DP profile and the
    microstep that phase 5 measured on the card (qwen3-1.7b at full depth,
    B=4 x S=1024), and over one online service time measured here.  Host
    only but the service probe.  Asserts: every input and result finite
    (an online p95 is NaN only where a policy served no request), every
    ``train_throughput_norm`` in (0, 1 + 1e-9], Exclusive's ``offline_norm``
    within 5 % of its normalisation point, a repeat of the SpecInF run equal
    to the first.  The paper's orderings and the two headline ratios are
    printed, not asserted: ``Calibration``'s constants were fitted to the
    paper's A100, not to this card."""
    import numpy as np
    import torch

    from repro_torch.configs import SpecInFConfig
    from repro_torch.core import simulator as sim
    from repro_torch.core.baselines import ALL_POLICIES
    from repro_torch.core.hardware import H100
    from repro_torch.core.profiles import (
        analytic_inference_profile,
        analytic_iteration,
        train_flops,
    )
    from repro_torch.core.queues import RequestQueue, poisson_arrivals
    from repro_torch.serving.core import Priority, SamplingParams
    from repro_torch.serving.engine import InferenceEngine

    t_phase = time.monotonic()
    cfg, profile, microstep_s = colloc["cfg"], colloc["profile"], colloc["microstep_s"]

    # one online service time on an idle engine, after one untimed warm-up
    eng = InferenceEngine(cfg, colloc["eparams"], max_slots=8, max_seq=512)
    rng = np.random.default_rng(28)
    secs = []
    for _ in range(2):
        req = eng.core.submit(rng.integers(0, cfg.vocab_size, SERVICE_PROMPT).astype(np.int32),
                              SamplingParams(max_new_tokens=SERVICE_NEW),
                              priority=Priority.ONLINE)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        while eng.core.has_unfinished:
            eng.core.step()
        torch.cuda.synchronize()
        secs.append(time.monotonic() - t0)
        if len(req.output_tokens) != SERVICE_NEW:
            raise AssertionError(f"policies: the service probe returned {req.output_tokens}")
    service_s = secs[1]
    del eng

    tokens = TRAIN_B * TRAIN_S
    analytic = analytic_iteration(cfg, seq_len=TRAIN_S, per_device_batch=TRAIN_B,
                                  num_devices=1, mode="dp", hw=H100)
    mfu = train_flops(cfg, tokens) / (profile.compute_s * H100.peak_flops)
    decode = analytic_inference_profile(cfg, batch=4, seq_or_context=512, hw=H100)
    inputs = (profile.compute_s, profile.bubble_s, microstep_s, service_s, analytic.compute_s,
              mfu, decode.min_exec_time_s)
    if not all(math.isfinite(x) and x > 0 for x in inputs):
        raise AssertionError(f"policies: inputs {inputs}")
    log(f"policies inputs (qwen3-1.7b, full depth, B={TRAIN_B} x S={TRAIN_S}, phase 5's "
        f"measure_dp_profile): train step compute {profile.compute_s * 1e3:.3f} ms; "
        f"bubbles SYNTHETIC (one card has no collective: comm_s = compute_s / 2, overlap "
        f"0.3): {profile.bubble_s * 1e3:.3f} ms of a {profile.iteration_s * 1e3:.3f} ms "
        f"iteration ({profile.bubble_fraction:.4f}), longest {profile.max_bubble_s * 1e3:.3f}"
        f" ms; decode microstep {microstep_s * 1e3:.4f} ms (4 slots); online service "
        f"{service_s * 1e3:.3f} ms ({SERVICE_PROMPT}-token prompt, {SERVICE_NEW} new, idle "
        f"engine; warm-up {secs[0] * 1e3:.1f} ms)")
    log(f"policies analytic vs measured (H100 spec: {H100.peak_flops:.3g} FLOP/s, "
        f"{H100.hbm_bandwidth:.3g} B/s): train compute {analytic.compute_s * 1e3:.3f} ms at "
        f"the assumed MFU {H100.mfu_assumption} vs {profile.compute_s * 1e3:.3f} ms measured "
        f"= MFU {mfu:.4f} ({train_flops(cfg, tokens) / 1e12:.3f} TFLOP a step); decode "
        f"microstep (batch 4, context 512, bytes bound) {decode.min_exec_time_s * 1e3:.4f} "
        f"ms vs {microstep_s * 1e3:.4f} ms measured ({microstep_s / decode.min_exec_time_s:.2f}x)")

    spec_cfg, cal = SpecInFConfig(busy_hold_ms=0.0), sim.Calibration()

    def run(policy, offline=0, online=False):
        kw = {}
        if online:
            kw = dict(online_queue=RequestQueue(poisson_arrivals(
                mean_interval_s=2 * service_s, num_requests=600, service_s=service_s,
                seed=0)), online_instances=3)
        return sim.simulate(profile, sim.make_policy(policy, spec_cfg), duration_s=POLICY_SIM_S,
                            offline_instances=offline, offline_microstep_s=microstep_s,
                            cal=cal, specinf_cfg=spec_cfg, **kw)

    t0 = time.monotonic()
    offline = {p: run(p, offline=1) for p in ALL_POLICIES}
    scaling = {m: run("specinf", offline=m) for m in (2, 4)}
    online = {p: run(p, online=True) for p in ALL_POLICIES}
    repeat = run("specinf", offline=1)
    sim_s = time.monotonic() - t0

    for label, res in [*((f"offline {p}", r) for p, r in offline.items()),
                       *((f"offline specinf x{m}", r) for m, r in scaling.items()),
                       *((f"online {p}", r) for p, r in online.items())]:
        f = _sim_fields(res)
        nans = [k for k, v in f.items() if v == "nan"
                and not (k.startswith("online_") and res.online_served == 0)]
        finite = all(math.isfinite(v) for v in f.values() if isinstance(v, float))
        if nans or not finite or not 0 < res.train_throughput_norm <= 1 + 1e-9:
            raise AssertionError(f"policies {label}: {f}")
        log(f"policies {label}: train_throughput_norm {res.train_throughput_norm!r}, "
            f"offline_norm {res.offline_norm!r} ({res.offline_completed} microsteps), "
            f"online_p95_s {res.online_p95_s!r} ({res.online_served} served), "
            f"online_mean_s {res.online_mean_s!r}")
    # Exclusive's offline_norm against its normalisation point: an instance
    # takes ceil(microstep / tick) whole ticks, so the point is
    # microstep / (ceil(microstep / tick) * tick), 1 where the microstep is
    # a whole number of ticks (the reference tests' 10 ms)
    tick = cal.tick_s
    point = microstep_s / (math.ceil(microstep_s / tick - 1e-9) * tick)
    excl = offline["exclusive"].offline_norm
    if not abs(excl / point - 1.0) <= 0.05:
        raise AssertionError(f"policies: Exclusive's offline_norm {excl} against its "
                             f"normalisation point {point}")
    if _sim_fields(repeat) != _sim_fields(offline["specinf"]):
        raise AssertionError("policies: a repeat of the SpecInF run differs from the first")
    spec_off, tgs_off = (offline[p].offline_throughput_per_s for p in ("specinf", "tgs"))
    tgs_ratio = spec_off / tgs_off if tgs_off > 0 else math.inf
    spec_p95, mps_p95 = online["specinf"].online_p95_s, online["mps"].online_p95_s
    p95_cut = 1.0 - spec_p95 / mps_p95  # NaN where SpecInF served no online request
    # the longest service SpecInF's pull gate admits on this profile: the
    # longest bubble must hold 1.15 x the 3 instances' drag x the service
    gate_s = profile.max_bubble_s / (1.15 * (1 + 2 * cal.multi_instance_drag))
    orderings = {
        "specinf train >= 0.93": offline["specinf"].train_throughput_norm >= 0.93,
        "co-exec train < specinf": (offline["co-exec"].train_throughput_norm
                                    < offline["specinf"].train_throughput_norm),
        "specinf offline > tgs": spec_off > tgs_off,
        "specinf offline > mps": spec_off > offline["mps"].offline_throughput_per_s,
        "specinf offline_norm in [0.15, 1]": 0.15 <= offline["specinf"].offline_norm <= 1.0,
        "specinf p95 < co-exec, mps": (spec_p95 < online["co-exec"].online_p95_s
                                       and spec_p95 < mps_p95),
        "x4 < 4 x1": (scaling[4].offline_throughput_per_s
                      < 4 * offline["specinf"].offline_throughput_per_s),
    }
    log(f"policies headline: SpecInF / TGS offline throughput {tgs_ratio!r} (paper: up to "
        f"14x); 1 - SpecInF p95 / MPS p95 = {p95_cut!r} (paper: 67 % lower; SpecInF's "
        f"gate admits services up to {gate_s * 1e3:.3f} ms here, the service is "
        f"{service_s * 1e3:.3f} ms); Exclusive "
        f"offline_norm {excl!r} against its point {point!r} (tick {tick * 1e3:g} ms); "
        f"paper orderings (printed, not asserted) {json.dumps(orderings)}; repeat equal; "
        f"{len(offline) + len(scaling) + len(online) + 1} timelines of {POLICY_SIM_S:g} s "
        f"simulated in {sim_s:.2f}s; phase {time.monotonic() - t_phase:.1f}s")
    return {"service_s": service_s, "gate_s": gate_s}


# ---------------------------------------------------------------------------
# 11. MoE parity, 12. MoE serve, 13. MoE train, 14. the other configs' serves
# ---------------------------------------------------------------------------

#: a capacity factor under which moonshot's monolithic prefill drops expert
#: choices: a 64- or 128-token bucket row offers 384 or 768 choices to 64
#: experts of 8 slots each
MOE_DROP_FACTOR = 0.25


def _fresh_phase():
    import torch

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def _end_phase(label):
    """Collect the phase's engines and weights, hand the cached blocks back,
    and log what is still allocated."""
    import torch

    gc.collect()
    torch.cuda.empty_cache()
    log(f"{label}: device memory allocated after the phase "
        f"{torch.cuda.memory_allocated() / 1e9:.3f} GB")


def _decode_weight_bytes(cfg):
    """bf16 bytes one decode step must read: every weight but the embedding
    table (of which it reads one row a slot); a tied table (qwen3-1.7b,
    olmo-1b) is the unembedding too and counts once, an untied one's
    ``lm_head`` counts once; for the MoE family every expert, since the
    capacity dispatch runs each expert over its whole buffer every step."""
    return 2 * (cfg.param_count() - (0 if cfg.tie_embeddings else cfg.vocab_size * cfg.d_model))


def _decode_step_ms(engine, slots):
    """Device-synchronised host time of one decode microstep with ``slots``
    requests running: one 8-step quantum (graph-replayed; a fresh engine
    captures its decode graphs in the untimed quantum before it), over 8;
    then 4 eager ``T.decode_step`` calls over the engine's cache (their K/V
    rows written where the next step writes again, a recurrent state put
    back), and 4 ``decode_microstep`` calls over the same slots (a graph
    replay and one fetch each; the first captures, untimed).  Leaves the
    core empty.  Returns (fused ms, microstep ms, eager step ms)."""
    import numpy as np
    import torch

    from repro_torch.models import transformer as T
    from repro_torch.serving.core import Priority, SamplingParams
    from repro_torch.serving.engine import DECODE_K_BUCKETS

    core, k = engine.core, DECODE_K_BUCKETS[-1]
    rng = np.random.default_rng(0)
    for _ in range(slots):
        core.submit(rng.integers(0, engine.cfg.vocab_size, 24).astype(np.int32),
                    SamplingParams(max_new_tokens=1 + 3 * k + 4), priority=Priority.OFFLINE)
    core.step()  # admits and prefills every probe request
    core.step()  # the untimed quantum
    torch.cuda.synchronize()
    t0 = time.monotonic()
    out = core.step()
    torch.cuda.synchronize()
    fused = (time.monotonic() - t0) / k
    if out.k != k or out.prefill_tokens or sum(len(o.new_tokens) for o in out.outputs) != k * slots:
        raise AssertionError(f"decode step probe: quantum k={out.k}, prefill "
                             f"{out.prefill_tokens} (k={k} over {slots} slots expected)")
    with torch.no_grad(), engine._states_kept():
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for _ in range(4):
            T.decode_step(engine.cfg, engine.params, engine.tokens, engine.cache,
                          compute_dtype=engine.compute_dtype, attn_impl=engine.attn_impl)
        torch.cuda.synchronize()
        eager = (time.monotonic() - t0) / 4
    micro = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        if len(engine.decode_microstep()) != (slots if _ == 3 else 0):
            raise AssertionError("decode step probe: the microsteps retired early or late")
        micro.append(time.monotonic() - t0)
    while core.has_unfinished:
        core.step()
    return fused * 1e3, sum(micro[1:]) / 3 * 1e3, eager * 1e3


def _serve_and_check(label, engine, cfg, prompts, max_new, kernels):
    """Serve ``prompts`` through EngineCore: every request must finish with
    ``max_new`` tokens and every kernel of ``kernels`` launch (plain
    versions never), each bf16 prefill / verify launch through the
    tensor-core body.  Returns the launch counts."""
    from repro_torch.kernels import ops

    ops.reset_launch_counts()
    reqs, secs = _serve(engine, prompts, max_new)
    counts = ops.launch_counts()
    _check_finished(label, reqs, max_new, cfg)
    _require_launches(label, counts, kernels)
    bodies = _require_tc_bodies(label, counts)
    tokens = sum(len(r.output_tokens) for r in reqs)
    log(f"{label}: prompts {min(map(len, prompts))}-{max(map(len, prompts))} tokens; "
        f"{_serve_summary(engine.obs.metrics, reqs, tokens, secs)}")
    log(f"{label} launches: "
        f"{json.dumps({k: v['cuda'] for k, v in counts.items() if v['cuda']})}; "
        f"bodies {json.dumps(bodies)}")
    return {name: c["cuda"] for name, c in counts.items()}


def _log_decode_step(label, engine, cfg, slots):
    """The decode step probe on a fresh engine (it captures the decode
    graphs, so the serve after it times no capture), beside the bound."""
    fused_ms, micro_ms, eager_ms = _decode_step_ms(engine, slots)
    nbytes = _decode_weight_bytes(cfg)
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"{label}: decode step at {slots} slots {fused_ms:.3f} ms (k=8 quantum"
        f"{', graph-replayed' if engine.graphs else ''}), decode_microstep "
        f"{micro_ms:.3f} ms (a graph replay, one fetch a step), eager T.decode_step "
        f"{eager_ms:.3f} ms; bound {bound:.3f} ms = "
        f"{nbytes / 1e9:.2f} GB of bf16 weights at 3.35 TB/s, {bound / fused_ms:.1%} of it")


def _microstep_parity():
    """qwen3-1.7b at 2 layers, full width, fp32, paged: ``decode_microstep``
    (its own graph, one fetch a step) against the fused loop (graph-replayed
    k=1 quanta) over the same schedule -- three admissions, one chunk wave that
    leaves the 80-token prompt PREFILLING, three decode steps, its last
    chunks, decode to the end.  Streams and transfers must be equal."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import InferenceEngine, Request

    cfg = dataclasses.replace(configs.get_config("qwen3-1.7b"), num_layers=2)
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    res = {}
    for mode in ("microstep", "fused"):
        eng = InferenceEngine(cfg, params, max_slots=3, max_seq=256,
                              compute_dtype=torch.float32)
        decode = eng.decode_microstep if mode == "microstep" else (
            lambda: eng._drive_decode_loop(1))
        rng = np.random.default_rng(0)
        reqs = [Request(prompt=rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                        max_new_tokens=m) for n, m in ((20, 6), (24, 9), (80, 5))]
        for r in reqs:
            eng._admit_request(r)
        eng._drive_prefill_chunks(20 + 24 + 32)
        for _ in range(3):
            decode()
        if eng.num_prefilling != 1:
            raise AssertionError(f"microstep parity: {eng.num_prefilling} PREFILLING slots")
        eng._drive_prefill_chunks()
        times = []
        while eng.num_active:
            t0 = time.monotonic()
            decode()
            torch.cuda.synchronize()
            times.append((time.monotonic() - t0) * 1e3)
        res[mode] = ([list(r.generated) for r in reqs], eng.d2h_transfers, sorted(times))
    if res["microstep"][:2] != res["fused"][:2]:
        raise AssertionError(f"microstep parity: decode_microstep streams / transfers "
                             f"{res['microstep'][:2]} differ from the fused loop's "
                             f"{res['fused'][:2]}")
    med = {m: r[2][len(r[2]) // 2] for m, r in res.items()}
    log(f"microstep parity (qwen3-1.7b, 2 layers, full width, fp32, paged): decode_microstep "
        f"streams and {res['fused'][1]} device-to-host transfers equal the fused loop's; "
        f"a step {med['microstep']:.3f} ms as decode_microstep's graph, {med['fused']:.3f} ms "
        f"as a k=1 decode-loop replay")


def phase_moe_parity():
    """moonshot-v1-16b-a3b at 2 layers, full width (64 experts top 6), fp32,
    impl="cuda" against impl="torch" on the same weights: model steps, then
    EngineCore streams and counters on the paged layout (graph-replayed
    decode, whose graphs must capture one paged decode launch a layer and
    step) and the dense layout, plain, paired with the 1-layer MoE draft
    (chain verify) and speculating from the n-gram lookup (tree verify),
    each speculating engine launching its layout's verify kernel; then
    monolithic prefill at a capacity factor that drops expert choices;
    then ``decode_microstep`` against the fused loop."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.configs import SpecDecodeConfig, draft_config
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import InferenceEngine

    _fresh_phase()
    cfg = dataclasses.replace(configs.get_config("moonshot-v1-16b-a3b"), num_layers=2)
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    _model_step_parity("moe parity model", cfg, params, np.random.default_rng(0))

    dcfg = draft_config(cfg)
    dparams = T.init_params(dcfg, torch.Generator(device="cuda").manual_seed(1))
    prompts = _prompts(np.random.default_rng(1), 6, 24, 80, cfg.vocab_size,
                       shared_prefix=32, shared_idx=(0, 5))
    # the n-gram engines run on a copy of the weights whose lm_head is the
    # embedding's transpose: greedy decoding then repeats tokens, as
    # qwen3-1.7b's tied weights do, so the lookup matches (untied random
    # weights walk a long random chain and it never does)
    ngram_params = {**params, "lm_head": params["embed"].T.contiguous()}
    # the verify kernel each speculating engine must reach: the draft
    # verifies a chain, the n-gram lookup a tree (GQA group 1 at T = 1..31)
    verify_kernel = {("paged", "draft"): "paged_verify_attention",
                     ("paged", "ngram"): "paged_tree_verify_attention",
                     ("dense", "draft"): "verify_attention",
                     ("dense", "ngram"): "tree_verify_attention"}
    report = []
    for layout, kw in (("paged", {}), ("dense", dict(kv_page_size=0))):
        for name, pkw in (("plain", {}),
                          ("draft", dict(draft_cfg=dcfg, draft_params=dparams,
                                         spec=SpecDecodeConfig(proposer="draft"))),
                          ("ngram", dict(spec=SpecDecodeConfig(proposer="ngram")))):
            res = {}
            for impl in ("cuda", "torch"):
                eng = InferenceEngine(cfg, ngram_params if name == "ngram" else params,
                                      max_slots=4, max_seq=256,
                                      compute_dtype=torch.float32, decode_impl=impl,
                                      **kw, **pkw)
                ops.reset_launch_counts()
                reqs, _ = _serve(eng, prompts, max_new=12)
                counts = ops.launch_counts()
                res[impl] = ([list(r.output_tokens) for r in reqs],
                             (eng.spec_rounds, eng.spec_accepted, eng.spec_drafted,
                              eng.prefill_skipped_tokens))
                if impl == "cuda" and layout == "paged" and name == "plain":
                    graphs = _decode_graph_launches("moe parity engine", eng, cfg)
                if impl == "cuda" and name != "plain":
                    verify = counts[verify_kernel[layout, name]]
                    if verify["cuda"] <= 0 or verify["torch"]:
                        raise AssertionError(f"moe parity: {layout} {name} engine launched "
                                             f"{verify_kernel[layout, name]} {verify}")
            if res["cuda"] != res["torch"]:
                raise AssertionError(f"moe parity: {layout} {name} streams or counters "
                                     f"differ (cuda vs torch): {res['cuda'][1]} vs "
                                     f"{res['torch'][1]}")
            if name != "plain" and res["cuda"][1][0] <= 0:
                raise AssertionError(f"moe parity: {layout} {name} engine ran no spec round")
            report.append(f"{layout} {name} (rounds/accepted/drafted/prefix-skipped "
                          f"{res['cuda'][1]}"
                          + (f"; {verify_kernel[layout, name]} launches {verify['cuda']}"
                             if name != "plain" else "") + ")")
    log(f"moe parity engine (2 layers, full width, fp32): " + "; ".join(report)
        + f"; streams equal cuda vs torch; the paged cuda engine's decode graphs captured "
        f"{graphs} paged decode launches (k: launches)")

    drop_cfg = dataclasses.replace(cfg, moe_capacity_factor=MOE_DROP_FACTOR)
    with torch.no_grad():
        dropped = [T.forward(drop_cfg, params, torch.tensor(p[None], device="cuda"),
                             compute_dtype=torch.float32)[1]["moe_dropped"].item()
                   for p in prompts]
    streams = {}
    for impl in ("cuda", "torch"):
        eng = InferenceEngine(drop_cfg, params, max_slots=4, max_seq=256, prefill_chunk=0,
                              compute_dtype=torch.float32, decode_impl=impl)
        reqs, _ = _serve(eng, prompts, max_new=12)
        streams[impl] = [list(r.output_tokens) for r in reqs]
    if streams["cuda"] != streams["torch"]:
        raise AssertionError("moe parity: streams differ (cuda vs torch) under capacity drops")
    if not min(dropped) > 0:
        raise AssertionError(f"moe parity: capacity factor {MOE_DROP_FACTOR} dropped "
                             f"{dropped} of the prompts' expert choices")
    log(f"moe parity capacity drops (factor {MOE_DROP_FACTOR}, monolithic prefill): "
        f"moe_dropped of a forward over each prompt " + ", ".join(f"{d:.3f}" for d in dropped)
        + "; streams equal cuda vs torch")
    del params, dparams, ngram_params, eng
    _microstep_parity()
    _end_phase("moe parity")


def phase_moe_serve():
    """moonshot-v1-16b-a3b at full depth and width (48 layers, 64 experts
    top 6), bf16 weights made on the card, 8 slots, max_seq 512, paged,
    32-token chunks: the serve phase's 16 ONLINE requests, 32 new tokens
    each; then the same with its 1-layer MoE draft and ``proposer="auto"``.
    Every request must finish, the paths' kernels launch, the decode graphs
    capture one paged decode launch a layer and step, and the router run
    both proposers.  Its profiled round is ``_profile_moe_serve``.  Returns
    the launch counts of the two runs."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import InferenceEngine
    from repro_torch.tree import tree_leaves

    _fresh_phase()
    cfg = configs.get_config("moonshot-v1-16b-a3b")
    t0 = time.monotonic()
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                           dtype=torch.bfloat16)
    t_start = time.monotonic()
    engine = InferenceEngine(cfg, params, max_slots=8, max_seq=512,
                             clock=lambda: time.monotonic() - t_start)
    torch.cuda.synchronize()
    n = sum(p.numel() for p in tree_leaves(params))
    log(f"moe serve: weights {n / 1e9:.3f} B params bf16 ({cfg.num_layers} layers, "
        f"{cfg.num_experts} experts top {cfg.experts_per_token}), KV pool "
        f"{engine.kv_cache_bytes() / 1e9:.3f} GB, set-up {time.monotonic() - t0:.1f}s")
    prompts = _prompts(np.random.default_rng(2), 16, 24, 136, cfg.vocab_size,
                       shared_prefix=64, shared_idx=(0, 13, 14, 15))
    _log_decode_step("moe serve", engine, cfg, 8)
    counts = _serve_and_check("moe serve", engine, cfg, prompts, 32, SERVE_KERNELS)
    graphs = _decode_graph_launches("moe serve", engine, cfg)
    log(f"moe serve: the decode graphs captured {graphs} paged decode launches")
    del engine
    gc.collect()
    t_start = time.monotonic()
    engine = _spec_engine(cfg, params, clock=lambda: time.monotonic() - t_start)
    spec_counts = _serve_and_check("moe spec serve", engine, cfg, prompts, 32,
                                   SPEC_KERNELS + ("paged_prefill_attention",))
    m = engine.obs.metrics
    per = {name: tuple(m.counter(f"spec/proposer/{w}/{name}").value
                       for w in ("rounds", "accepted", "proposed")) for name in ("draft", "ngram")}
    if min(r for r, _, _ in per.values()) <= 0:
        raise AssertionError(f"moe spec serve: the router did not run both proposers: {per}")
    log(f"moe spec serve: spec rounds {engine.spec_rounds}, acceptance "
        f"{engine.spec_acceptance_rate:.4f}; per proposer (rounds, accepted, proposed) {per}")
    del engine, params
    _end_phase("moe serve")
    return counts, spec_counts


def _profile_moe_serve():
    """Phase 12's profiled round, in the end-of-run profiler block: the
    same seeded bf16 weights and plain engine, its decode step probed again
    (which captures the decode graphs, so none is captured under the
    profiler), then ``_profile_serve``."""
    import torch

    from repro_torch import configs
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import InferenceEngine

    _fresh_phase()
    cfg = configs.get_config("moonshot-v1-16b-a3b")
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                           dtype=torch.bfloat16)
    engine = InferenceEngine(cfg, params, max_slots=8, max_seq=512)
    _log_decode_step("moe serve (profiled engine)", engine, cfg, 8)
    _profile_serve(engine, cfg, "moe serve")
    del engine, params
    _end_phase("moe serve profile")


def _profile_hybrid_serve():
    """Phase 16's engine (the same seeded bf16 weights) in the end-of-run
    profiler block: ``_profile_serve`` with the dense decode kernel's
    launches and device time."""
    import torch

    from repro_torch import configs
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import InferenceEngine

    _fresh_phase()
    cfg = configs.get_config("zamba2-2.7b")
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                           dtype=torch.bfloat16)
    engine = InferenceEngine(cfg, params, max_slots=8, max_seq=512)
    _profile_serve(engine, cfg, "hybrid serve", kernel="dense_decode_cluster_kernel")
    del engine, params
    _end_phase("hybrid serve profile")


def phase_moe_train():
    """moonshot-v1-16b-a3b at full width, 2 of 48 layers (full depth would
    need ~450 GB of fp32 params, grads and moments): fp32 params and AdamW,
    bf16 compute, batch 4 x seq 1024 synthetic, 3 steps.  Loss and moe_aux
    must be finite, the router's gradient non-zero (its first moment), and
    the flash forward and backward launch once a layer and step.  Returns
    the launch counts."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.configs import TrainConfig
    from repro_torch.data import SyntheticDataset
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.runtime import init_train_state, make_train_step

    _fresh_phase()
    cfg = dataclasses.replace(configs.get_config("moonshot-v1-16b-a3b"), num_layers=2)
    steps = 3
    state = init_train_state(T.init_params(cfg, torch.Generator(device="cuda").manual_seed(0)))
    step = make_train_step(cfg, TrainConfig(warmup_steps=2, total_steps=steps + 2))
    ds = SyntheticDataset(cfg, seq_len=TRAIN_S, global_batch=TRAIN_B, seed=0)
    ops.reset_launch_counts()
    losses, auxes, ms = [], [], []
    for _ in range(steps):
        batch = ds.next_batch()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        ms.append((time.monotonic() - t0) * 1e3)
        losses.append(metrics["loss"].item())
        auxes.append(metrics["moe_aux"].item())
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    if not (np.isfinite(losses).all() and np.isfinite(auxes).all() and min(auxes) > 0):
        raise AssertionError(f"moe train: losses {losses}, moe_aux {auxes}")
    router_mu = state["opt"]["mu"]["layers"]["ffn"]["router"].abs().max().item()
    if not router_mu > 0:
        raise AssertionError("moe train: the router's gradient is zero")
    _require_launches("moe train", counts, TRAIN_KERNELS)
    for name in TRAIN_KERNELS:
        if counts[name]["cuda"] != cfg.num_layers * steps:
            raise AssertionError(f"moe train: {name} launched {counts[name]['cuda']} times "
                                 f"({cfg.num_layers} a step expected)")
    with torch.no_grad():
        _, fm = T.forward(cfg, state["params"], torch.as_tensor(batch["inputs"], device="cuda"))
    log(f"moe train (moonshot-v1-16b-a3b, 2 layers, full width; fp32 params + AdamW, bf16 "
        f"compute, B={TRAIN_B} x S={TRAIN_S}): steps " + ", ".join(f"{t:.1f}" for t in ms)
        + f" ms; losses " + ", ".join(f"{x:.4f}" for x in losses) + "; moe_aux "
        + ", ".join(f"{x:.4f}" for x in auxes) + f"; moe_dropped {fm['moe_dropped'].item():.4f} "
        f"(capacity {TRAIN_S}-token rows); router |mu| max {router_mu:.3e}; peak device "
        f"memory {peak:.2f} GB; flash launches "
        + json.dumps({k: counts[k]["cuda"] for k in TRAIN_KERNELS}))
    del state, step, fm
    _end_phase("moe train")
    return {name: c["cuda"] for name, c in counts.items()}


#: (run label, arch, layers (None: full depth), slots, requests): 16 new
#: tokens each, max_seq 512, paged with 32-token chunks
CONFIG_SERVES = (
    ("dbrx_serve", "dbrx-132b", 4, 8, 8),
    ("qwen2_serve", "qwen2-7b", None, 8, 8),
    ("deepseek_serve", "deepseek-coder-33b", None, 4, 4),
)
#: phase 26's row: olmo-1b at full depth
OLMO_SERVES = (("olmo_serve", "olmo-1b", None, 8, 8),)


def phase_config_serves(rows=CONFIG_SERVES):
    """Phase 14: dbrx-132b at full width and 4 of 40 layers (its 264 GB of
    bf16 weights do not fit the card), qwen2-7b and deepseek-coder-33b at
    full depth and width; phase 26: olmo-1b at full depth (``OLMO_SERVES``).
    Each in bf16 (weights made on the card), one at a time: every request
    finishes and both paged kernels launch; the decode step beside its
    bound, whose bytes are the engine's weights less one table when the
    embedding is untied.  Returns {run label: launch counts}."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import InferenceEngine
    from repro_torch.tree import tree_leaves

    out = {}
    for label, arch, layers, slots, n_req in rows:
        _fresh_phase()
        cfg = configs.get_config(arch)
        if layers is not None:
            cfg = dataclasses.replace(cfg, num_layers=layers)
        t0 = time.monotonic()
        params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                               dtype=torch.bfloat16)
        t_start = time.monotonic()
        engine = InferenceEngine(cfg, params, max_slots=slots, max_seq=512,
                                 clock=lambda: time.monotonic() - t_start)
        del params
        torch.cuda.synchronize()
        name = label.replace("_", " ")
        weights = 2 * sum(p.numel() for p in tree_leaves(engine.params))  # at bf16
        table = 0 if cfg.tie_embeddings else 2 * cfg.vocab_size * cfg.d_model
        if _decode_weight_bytes(cfg) != weights - table:
            raise AssertionError(f"{name}: the decode bound counts {_decode_weight_bytes(cfg)} "
                                 f"bytes, the engine holds {weights} (table {table})")
        log(f"{name}: {arch} at {cfg.num_layers} layers, {cfg.param_count() / 1e9:.3f} B "
            f"params bf16, KV pool {engine.kv_cache_bytes() / 1e9:.3f} GB, set-up "
            f"{time.monotonic() - t0:.1f}s; decode bound bytes {weights - table} = the "
            f"engine's weights{' (tied table once)' if cfg.tie_embeddings else ' less one table'}")
        prompts = _prompts(np.random.default_rng(6), n_req, 24, 136, cfg.vocab_size, 0, ())
        _log_decode_step(name, engine, cfg, slots)
        out[label] = _serve_and_check(name, engine, cfg, prompts, 16, SERVE_KERNELS)
        graphs = _decode_graph_launches(name, engine, cfg)
        log(f"{name}: the decode graphs captured {graphs} paged decode launches")
        del engine
        _end_phase(name)
    return out


# ---------------------------------------------------------------------------
# 15. hybrid parity, 16. hybrid serve, 17. hybrid train (zamba2-2.7b)
# ---------------------------------------------------------------------------


def _hybrid_launches(label, counts, cfg, admissions, decode_steps):
    """The hybrid serving path's kernels launched (plain versions never):
    the flash forward once per cycle and admission, the dense decode once
    per cycle and decode microstep."""
    n_cyc = cfg.num_layers // cfg.shared_attn_every
    _require_launches(label, counts, HYBRID_SERVE_KERNELS)
    want = {"flash_attention_fwd": n_cyc * admissions, "decode_attention": n_cyc * decode_steps}
    got = {name: counts[name]["cuda"] for name in want}
    if got != want:
        raise AssertionError(f"{label}: launches {got}, expected {want} ({n_cyc} cycles, "
                             f"{admissions} admissions, {decode_steps} decode steps)")
    return got


def phase_hybrid_parity():
    """zamba2-2.7b at full width and 12 of 54 layers (2 cycles, so the
    shared block is reused), fp32 weights, impl="cuda" against
    impl="torch" on the card: forward logits (B=2, S=200) within
    LOGITS_ATOL; a prompt of 100 tokens prefilled padded to its 128 bucket
    and unpadded (cuda) with bit-equal logits and Mamba2 state; EngineCore
    streams on the dense layout (4 slots, 8 requests) equal, the cuda
    engine launching flash once per cycle and admission and the dense
    decode once per cycle and decode step."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import InferenceEngine

    _fresh_phase()
    cfg = dataclasses.replace(configs.get_config("zamba2-2.7b"),
                              num_layers=HYBRID_PARITY_LAYERS)
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    rng = np.random.default_rng(7)
    toks = torch.tensor(rng.integers(0, cfg.vocab_size, (2, 200)), device="cuda")
    with torch.no_grad():
        logits = {impl: T.forward(cfg, params, toks, impl=impl, compute_dtype=torch.float32)[0]
                  for impl in ("cuda", "torch")}
    err = (logits["cuda"] - logits["torch"]).abs().max().item()
    if not (err <= LOGITS_ATOL and torch.isfinite(logits["cuda"]).all()):
        raise AssertionError(f"hybrid parity: forward logits differ by {err} > {LOGITS_ATOL}")
    del logits

    prompt = torch.tensor(rng.integers(0, cfg.vocab_size, (1, 100)), dtype=torch.int32,
                          device="cuda")
    padded = torch.nn.functional.pad(prompt, (0, 28))
    kw = dict(impl="cuda", compute_dtype=torch.float32)
    l_r, c_r = T.prefill(cfg, params, prompt, 256, **kw)
    l_p, c_p = T.prefill(cfg, params, padded, 256, length=100, **kw)
    same = torch.equal(l_r, l_p) and all(
        torch.equal(t, c_p["layers"]["mamba"][k]) for k, t in c_r["layers"]["mamba"].items())
    if not same:
        raise AssertionError("hybrid parity: the padded-bucket prefill differs from the "
                             "unpadded one")
    del c_r, c_p

    prompts = _prompts(np.random.default_rng(8), 8, 24, 120, cfg.vocab_size, 0, ())
    res = {}
    for impl in ("cuda", "torch"):
        eng = InferenceEngine(cfg, params, max_slots=4, max_seq=256,
                              compute_dtype=torch.float32, decode_impl=impl)
        ops.reset_launch_counts()
        reqs, _ = _serve(eng, prompts, max_new=12)
        res[impl] = ([list(r.output_tokens) for r in reqs], ops.launch_counts(),
                     eng.steps_executed)
        del eng
    if res["cuda"][0] != res["torch"][0]:
        raise AssertionError("hybrid parity: streams differ (cuda vs torch)")
    got = _hybrid_launches("hybrid parity", res["cuda"][1], cfg, len(prompts),
                           res["cuda"][2] - len(prompts))
    log(f"hybrid parity (zamba2-2.7b, {cfg.num_layers} layers = 2 cycles, full width, fp32): "
        f"forward logits max err {err:.2e} (tol {LOGITS_ATOL:g}); padded 128-bucket prefill "
        f"of a 100-token prompt bit-equal to the unpadded one (logits and Mamba2 state); "
        f"{len(prompts)} requests on the dense layout, streams equal; cuda launches "
        f"{json.dumps(got)}")
    del params, res
    _end_phase("hybrid parity")


def _hybrid_decode_bytes(cfg, slots):
    """bf16 bytes one hybrid decode step must move: every weight but the
    embedding, the shared block's read once per cycle; and each slot's
    fp32 SSM state and its conv windows, read and written."""
    n_cyc = cfg.num_layers // cfg.shared_attn_every
    d = cfg.d_model
    shared = cfg._attn_params(d, cfg.resolved_head_dim) + 3 * d * cfg.d_ff + 2 * d
    weights = cfg.param_count() - cfg.vocab_size * d + (n_cyc - 1) * shared
    state = cfg.num_layers * (4 * cfg.ssm_num_heads * cfg.ssm_head_dim * cfg.ssm_state
                              + 2 * (cfg.ssm_conv - 1) * (cfg.d_inner + 2 * cfg.ssm_state))
    return 2 * weights, 2 * slots * state


def phase_hybrid_serve():
    """zamba2-2.7b at full depth and width (54 Mamba2 layers, the shared
    block 9 times), bf16 weights made on the card, 8 slots, max_seq 512:
    the decode step probed first (8 OFFLINE slots, k = 8, graph-replayed), beside its
    bytes bound; then the ssm serve's 16 ONLINE requests of 35-154 tokens,
    32 new tokens each, on the dense layout with monolithic bucket prefill.
    Every request finishes; the flash forward launches once per cycle and
    admission, the dense decode once per cycle and decode step.  Returns
    the launch counts."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import InferenceEngine

    _fresh_phase()
    cfg = configs.get_config("zamba2-2.7b")
    slots = 8
    t0 = time.monotonic()
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                           dtype=torch.bfloat16)
    t_start = time.monotonic()
    engine = InferenceEngine(cfg, params, max_slots=slots, max_seq=512,
                             clock=lambda: time.monotonic() - t_start)
    del params
    torch.cuda.synchronize()
    log(f"hybrid serve: zamba2-2.7b, {cfg.param_count() / 1e9:.3f} B params bf16, cache "
        f"(Mamba2 state + shared K/V rows) {engine.kv_cache_bytes() / 1e6:.1f} MB, set-up "
        f"{time.monotonic() - t0:.1f}s")
    fused_ms, micro_ms, eager_ms = _decode_step_ms(engine, slots)
    w_bytes, s_bytes = _hybrid_decode_bytes(cfg, slots)
    bound = (w_bytes + s_bytes) / HBM_BYTES_PER_S * 1e3
    log(f"hybrid serve: decode step at {slots} slots {fused_ms:.3f} ms (k=8 quantum"
        f"{', graph-replayed' if engine.graphs else ', eager'}), "
        f"decode_microstep {micro_ms:.3f} ms (a graph replay), eager T.decode_step "
        f"{eager_ms:.3f} ms; bound {bound:.3f} ms = {w_bytes / 1e9:.2f} GB "
        f"of bf16 weights (the shared block 9 times) + {s_bytes / 1e9:.3f} GB of SSM and "
        f"conv state read and written at 3.35 TB/s, {bound / fused_ms:.1%} of it")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
               for n in rng.integers(25, 158, 16)]
    max_new = 32
    torch.cuda.reset_peak_memory_stats()
    steps0 = engine.steps_executed
    ops.reset_launch_counts()
    reqs, secs = _serve(engine, prompts, max_new)
    counts = ops.launch_counts()
    _check_finished("hybrid serve", reqs, max_new, cfg)
    got = _hybrid_launches("hybrid serve", counts, cfg, len(prompts),
                           engine.steps_executed - steps0 - len(prompts))
    tokens = sum(len(r.output_tokens) for r in reqs)
    log(f"hybrid serve: prompts {min(map(len, prompts))}-{max(map(len, prompts))} tokens; "
        f"{_serve_summary(engine.obs.metrics, reqs, tokens, secs)}; launches {json.dumps(got)}")
    del engine
    _end_phase("hybrid serve")
    return {name: c["cuda"] for name, c in counts.items()}


def phase_hybrid_train():
    """zamba2-2.7b at full depth and width under remat "full" (each cycle
    recomputed in the backward): fp32 params and AdamW (38.8 GB of state),
    bf16 compute, batch 4 x seq 1024 Zipf tokens, 3 steps.  Loss and
    gradient norm finite; the flash forward twice per cycle and step (the
    recompute), the backward once.  Returns the launch counts."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.configs import TrainConfig
    from repro_torch.data import SyntheticDataset
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.runtime import init_train_state, make_train_step

    _fresh_phase()
    cfg = configs.get_config("zamba2-2.7b")
    n_cyc, steps = cfg.num_layers // cfg.shared_attn_every, 3
    state = init_train_state(T.init_params(cfg, torch.Generator(device="cuda").manual_seed(0)))
    step = make_train_step(cfg, TrainConfig(warmup_steps=2, total_steps=steps + 2,
                                            remat_policy="full"))
    ds = SyntheticDataset(cfg, seq_len=TRAIN_S, global_batch=TRAIN_B, seed=0)
    torch.cuda.synchronize()
    log(f"hybrid train: state {torch.cuda.memory_allocated() / 1e9:.2f} GB before the first "
        f"step")
    ops.reset_launch_counts()
    losses, norms, ms = [], [], []
    for _ in range(steps):
        batch = ds.next_batch()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        ms.append((time.monotonic() - t0) * 1e3)
        losses.append(metrics["loss"].item())
        norms.append(metrics["grad_norm"].item())
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    if not (np.isfinite(losses).all() and np.isfinite(norms).all() and min(norms) > 0):
        raise AssertionError(f"hybrid train: losses {losses}, grad norms {norms}")
    _require_launches("hybrid train", counts, TRAIN_KERNELS)
    want = {"flash_attention_fwd": 2 * n_cyc * steps, "flash_attention_bwd": n_cyc * steps}
    got = {name: counts[name]["cuda"] for name in want}
    if got != want:
        raise AssertionError(f"hybrid train: flash launches {got}, expected {want}")
    log(f"hybrid train (zamba2-2.7b, full depth and width, remat full; fp32 params + AdamW, "
        f"bf16 compute, B={TRAIN_B} x S={TRAIN_S}): steps " + ", ".join(f"{t:.1f}" for t in ms)
        + " ms; losses " + ", ".join(f"{x:.4f}" for x in losses) + "; grad norms "
        + ", ".join(f"{x:.4f}" for x in norms) + f"; peak device memory {peak:.2f} GB; flash "
        f"launches {json.dumps(got)}")
    del state, step
    _end_phase("hybrid train")
    return {name: c["cuda"] for name, c in counts.items()}


def _profile_train(arch="qwen3-1.7b", label="train", remat_policy="none"):
    """Where the train step's time goes: phase 5's model and step (or
    ``arch``'s at full depth under ``remat_policy``), on fresh weights after
    one warm-up step, for one step under ``torch.profiler`` -- device busy
    share of its wall time, the flash kernels' share of the device time,
    and the top kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import configs
    from repro_torch.configs import TrainConfig
    from repro_torch.data import SyntheticDataset
    from repro_torch.models import transformer as T
    from repro_torch.runtime import init_train_state, make_train_step

    gc.collect()
    torch.cuda.empty_cache()
    cfg = configs.get_config(arch)
    tcfg = TrainConfig(warmup_steps=2, total_steps=COLLOC_ITERS + 2, remat_policy=remat_policy)
    state = init_train_state(T.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0),
        dtype=getattr(torch, tcfg.param_dtype)))
    step = make_train_step(cfg, tcfg)
    ds = SyntheticDataset(cfg, seq_len=TRAIN_S, global_batch=TRAIN_B, seed=0)
    step(state, ds.next_batch())
    torch.cuda.synchronize()
    batch = ds.next_batch()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        step(state, batch)
        torch.cuda.synchronize()
        secs = time.monotonic() - t0
    del state, step
    got = _busy_and_top(prof)
    if got is None:
        log(f"{label} profile: the profiler saw no device time (not measured)")
        return
    busy, n, by_name = got
    total = sum(by_name.values())
    flash = {k: v for k, v in by_name.items() if "flash_" in k}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    log(f"{label} profile (1 step, profiler on): wall {secs:.3f}s, device busy {busy:.3f}s "
        f"({100 * busy / secs:.1f}%), {n} kernels; flash kernels {sum(flash.values()):.3f}s "
        f"({100 * sum(flash.values()) / total:.1f}% of device time: " + ", ".join(
            f"{k.split('<')[0].split('::')[-1]} {v * 1e3:.1f}ms"
            for k, v in sorted(flash.items())) +
        "); top: " + "; ".join(f"{k[:50]} {v * 1e3:.1f}ms" for k, v in top))


# ---------------------------------------------------------------------------
# 18. audio / VLM parity, 19. musicgen-large serve, 20. pixtral-12b serve,
# 21. audio / VLM train
# ---------------------------------------------------------------------------

#: (label, engine keywords, draft-paired, kernels the cuda engine launches:
#: a draft-paired engine's target verifies every decode step, its draft
#: proposes on the dense decode and streams chunks through the dense prefill)
AV_PARITY_ENGINES = (
    ("paged, chunked", {}, False, SERVE_KERNELS),
    ("paged, chunked, draft", {}, True,
     ("paged_prefill_attention", "decode_attention", "prefill_attention",
      "paged_verify_attention")),
    ("dense, monolithic", {"kv_page_size": 0, "prefill_chunk": 0}, False,
     ("flash_attention_fwd", "decode_attention")),
    ("dense, monolithic, draft", {"kv_page_size": 0, "prefill_chunk": 0}, True,
     ("flash_attention_fwd", "decode_attention", "verify_attention")),
)


def phase_audio_vlm_parity():
    """musicgen-large and pixtral-12b at full width and 2 layers, fp32
    weights, impl="cuda" against impl="torch" on the card: logits from
    stub-frontend embeddings (B=2, S=200) within LOGITS_ATOL; a 100-token
    prompt prefilled (padded to its 128 bucket) from ``params["embed"]``'s
    rows bit-equal to the same tokens' prefill (cuda); ``EngineCore``
    streams on the paged layout (chunked prefill) and the dense layout
    (monolithic prefill, whose admissions feed embeddings), plain and
    paired with ``draft_config``'s draft (``proposer="draft"``), equal, each
    cuda engine launching its path's kernels and no plain version."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.configs import SpecDecodeConfig, draft_config
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import InferenceEngine

    for arch in ("musicgen-large", "pixtral-12b"):
        _fresh_phase()
        t0 = time.monotonic()
        cfg = dataclasses.replace(configs.get_config(arch), num_layers=AV_PARITY_LAYERS)
        params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
        rng = np.random.default_rng(9)
        emb = torch.tensor(rng.standard_normal((2, 200, cfg.d_model)) * 0.5,
                           dtype=torch.float32, device="cuda")
        with torch.no_grad():
            logits = {impl: T.forward(cfg, params, emb, impl=impl,
                                      compute_dtype=torch.float32)[0]
                      for impl in ("cuda", "torch")}
        err = (logits["cuda"] - logits["torch"]).abs().max().item()
        if not (err <= LOGITS_ATOL and torch.isfinite(logits["cuda"]).all()):
            raise AssertionError(f"{arch} parity: logits from embeddings differ by {err}")
        del logits

        buf = torch.zeros((1, 128), dtype=torch.int32, device="cuda")
        buf[0, :100] = torch.tensor(rng.integers(0, cfg.vocab_size, 100), device="cuda")
        kw = dict(impl="cuda", compute_dtype=torch.float32, length=100)
        with torch.no_grad():
            l_tok, c_tok = T.prefill(cfg, params, buf, 256, **kw)
            l_emb, c_emb = T.prefill(cfg, params, params["embed"][buf.long()], 256, **kw)
        same = torch.equal(l_tok, l_emb) and all(
            torch.equal(c_tok["layers"][n], c_emb["layers"][n]) for n in ("k", "v"))
        if not same:
            raise AssertionError(f"{arch} parity: the prefill from embeddings differs from "
                                 f"the prefill from tokens")
        del c_tok, c_emb

        spec = SpecDecodeConfig(proposer="draft")
        dcfg = draft_config(cfg, spec)
        dparams = T.init_params(dcfg, torch.Generator(device="cuda").manual_seed(1))
        prompts = _prompts(np.random.default_rng(10), 6, 24, 80, cfg.vocab_size,
                           shared_prefix=32, shared_idx=(0, 5))
        done = []
        for label, kw, draft, kernels in AV_PARITY_ENGINES:
            dkw = dict(draft_cfg=dcfg, draft_params=dparams, spec=spec) if draft else {}
            streams = {}
            for impl in ("cuda", "torch"):
                eng = InferenceEngine(cfg, params, max_slots=4, max_seq=256,
                                      compute_dtype=torch.float32, decode_impl=impl,
                                      **kw, **dkw)
                ops.reset_launch_counts()
                reqs, _ = _serve(eng, prompts, max_new=10)
                counts = ops.launch_counts()
                _check_finished(f"{arch} parity ({label})", reqs, 10, cfg)
                streams[impl] = [list(r.output_tokens) for r in reqs]
                if impl == "cuda":
                    _require_launches(f"{arch} parity ({label})", counts, kernels)
                    spec_rounds = eng.spec_rounds
                del eng
            if streams["cuda"] != streams["torch"]:
                raise AssertionError(f"{arch} parity ({label}): streams differ (cuda vs torch)")
            if draft and spec_rounds <= 0:
                raise AssertionError(f"{arch} parity ({label}): no spec round")
            done.append(label)
        log(f"audio / vlm parity ({arch}, {cfg.num_layers} layers, full width, fp32): logits "
            f"from embeddings (B=2, S=200) max err {err:.2e} (tol {LOGITS_ATOL:g}); a "
            f"100-token prompt's prefill from its embedding rows bit-equal to its tokens'; "
            f"{len(prompts)} requests, streams equal on " + "; ".join(done)
            + f"; set-up and checks {time.monotonic() - t0:.1f}s")
        del params, dparams, dkw, emb
        _end_phase(f"{arch} parity")


def _serve_prompts(vocab):
    """Phase 7's traffic: 16 prompts, four sharing a 64-token prefix."""
    import numpy as np

    return _prompts(np.random.default_rng(2), 16, 24, 136, vocab, shared_prefix=64,
                    shared_idx=(0, 13, 14, 15))


def phase_musicgen_serve():
    """musicgen-large at full depth and width (48 layers, 32 MHA heads of
    64), bf16 weights made on the card (6.5 GB), 8 slots, max_seq 512,
    paged, 32-token chunks, graph-replayed decode: the decode step probed
    first, beside its bytes bound; phase 7's 16 ONLINE requests (EnCodec
    code ids), 32 new tokens each; then the same paired with its 1-layer
    draft, ``proposer="auto"`` (the router must run the draft and the
    n-gram lookup).  Every request finishes, every kernel of each path
    launches, no plain version.  Returns {run: launch counts}."""
    import torch

    from repro_torch import configs
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import InferenceEngine

    _fresh_phase()
    t_phase = time.monotonic()
    cfg = configs.get_config("musicgen-large")
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                           dtype=torch.bfloat16)
    t_start = time.monotonic()
    engine = InferenceEngine(cfg, params, max_slots=8, max_seq=512,
                             clock=lambda: time.monotonic() - t_start)
    torch.cuda.synchronize()
    log(f"musicgen serve: {cfg.param_count() / 1e9:.3f} B params bf16, KV pool "
        f"{engine.kv_cache_bytes() / 1e9:.3f} GB, set-up {time.monotonic() - t_phase:.1f}s")
    prompts = _serve_prompts(cfg.vocab_size)
    _log_decode_step("musicgen serve", engine, cfg, 8)
    counts = _serve_and_check("musicgen serve", engine, cfg, prompts, 32, SERVE_KERNELS)
    graphs = _decode_graph_launches("musicgen serve", engine, cfg)
    log(f"musicgen serve: the decode graphs captured {graphs} paged decode launches")
    del engine
    gc.collect()
    t_start = time.monotonic()
    engine = _spec_engine(cfg, params, clock=lambda: time.monotonic() - t_start)
    spec_counts = _serve_and_check("musicgen spec serve", engine, cfg, prompts, 32,
                                   SPEC_KERNELS + ("paged_prefill_attention",))
    m = engine.obs.metrics
    per = {name: tuple(m.counter(f"spec/proposer/{w}/{name}").value
                       for w in ("rounds", "accepted", "proposed")) for name in ("draft", "ngram")}
    if min(r for r, _, _ in per.values()) <= 0:
        raise AssertionError(f"musicgen spec serve: the router did not run both proposers: "
                             f"{per}")
    log(f"musicgen spec serve: spec rounds {engine.spec_rounds}, acceptance "
        f"{engine.spec_acceptance_rate:.4f}; per proposer (rounds, accepted, proposed) {per}; "
        f"phase {time.monotonic() - t_phase:.1f}s")
    del engine, params
    _end_phase("musicgen serve")
    return {"musicgen_serve": counts, "musicgen_spec_serve": spec_counts}


def phase_pixtral_serve():
    """pixtral-12b at full depth and width (40 layers, 32 heads over 8 kv
    heads of 128, vocab 131072), bf16 weights made on the card (24.5 GB), 8
    slots, max_seq 512: the decode step probed first, beside its bytes
    bound; phase 7's 16 ONLINE requests (text token ids), 32 new tokens
    each, paged with 32-token chunks; then 4 of them on the dense layout
    with monolithic prefill (``kv_page_size=0, prefill_chunk=0``), whose
    admissions feed the stub frontend's embeddings through the flash
    kernel (one launch a layer and admission).  Every request finishes,
    every kernel of each path launches, no plain version.  Returns {run:
    launch counts}."""
    import torch

    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import InferenceEngine

    _fresh_phase()
    t_phase = time.monotonic()
    cfg = configs.get_config("pixtral-12b")
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                           dtype=torch.bfloat16)
    t_start = time.monotonic()
    engine = InferenceEngine(cfg, params, max_slots=8, max_seq=512,
                             clock=lambda: time.monotonic() - t_start)
    torch.cuda.synchronize()
    log(f"pixtral serve: {cfg.param_count() / 1e9:.3f} B params bf16, KV pool "
        f"{engine.kv_cache_bytes() / 1e9:.3f} GB, set-up {time.monotonic() - t_phase:.1f}s")
    prompts = _serve_prompts(cfg.vocab_size)
    _log_decode_step("pixtral serve", engine, cfg, 8)
    counts = _serve_and_check("pixtral serve", engine, cfg, prompts, 32, SERVE_KERNELS)
    graphs = _decode_graph_launches("pixtral serve", engine, cfg)
    log(f"pixtral serve: the decode graphs captured {graphs} paged decode launches")
    del engine
    gc.collect()
    engine = InferenceEngine(cfg, params, max_slots=8, max_seq=512, kv_page_size=0,
                             prefill_chunk=0)
    ops.reset_launch_counts()
    reqs, secs = _serve(engine, prompts[:4], 16)
    dense = ops.launch_counts()
    _check_finished("pixtral serve, dense monolithic", reqs, 16, cfg)
    _require_launches("pixtral serve, dense monolithic", dense,
                      ("flash_attention_fwd", "decode_attention"))
    if dense["flash_attention_fwd"]["cuda"] != cfg.num_layers * len(reqs):
        raise AssertionError(f"pixtral serve, dense monolithic: flash launched "
                             f"{dense['flash_attention_fwd']['cuda']} times ("
                             f"{cfg.num_layers} a layer and admission expected)")
    log(f"pixtral serve, dense monolithic: {len(reqs)} requests of "
        f"{min(map(len, prompts[:4]))}-{max(map(len, prompts[:4]))} tokens, 16 new each, in "
        f"{secs:.3f}s; launches "
        f"{json.dumps({k: v['cuda'] for k, v in dense.items() if v['cuda']})}; phase "
        f"{time.monotonic() - t_phase:.1f}s")
    del engine, params
    _end_phase("pixtral serve")
    return {"pixtral_serve": counts,
            "pixtral_dense": {name: c["cuda"] for name, c in dense.items()}}


def phase_audio_vlm_train():
    """musicgen-large at full depth and width and pixtral-12b at full width
    and ``PIXTRAL_TRAIN_LAYERS`` of 40 layers, each under remat "full": fp32
    params + AdamW, bf16 compute, batch 4 x seq 1024 from the port's
    ``SyntheticDataset`` (the stub frontend's fp32 embeddings, [4, 1024,
    d_model]), 3 steps.  Loss and gradient norm finite; every leaf's
    gradient non-zero (its AdamW first moment) but the embedding table's,
    which embedding inputs never read (zero, as the reference's); the flash
    forward twice a layer and step (the recompute), the backward once.  The
    batch's host -> device copy is timed beside the step.  Returns {run:
    launch counts}."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.configs import TrainConfig
    from repro_torch.data import SyntheticDataset
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.runtime import init_train_state, make_train_step
    from repro_torch.tree import tree_leaves

    out = {}
    for label, arch, layers in (("musicgen_train", "musicgen-large", None),
                                ("pixtral_train", "pixtral-12b", PIXTRAL_TRAIN_LAYERS)):
        _fresh_phase()
        t_phase = time.monotonic()
        cfg = configs.get_config(arch)
        if layers is not None:
            cfg = dataclasses.replace(cfg, num_layers=layers)
        steps = 3
        state = init_train_state(T.init_params(cfg,
                                               torch.Generator(device="cuda").manual_seed(0)))
        step = make_train_step(cfg, TrainConfig(warmup_steps=2, total_steps=steps + 2,
                                                remat_policy="full"))
        ds = SyntheticDataset(cfg, seq_len=TRAIN_S, global_batch=TRAIN_B, seed=0)
        torch.cuda.synchronize()
        name = label.replace("_", " ")
        log(f"{name}: {arch} at {cfg.num_layers} layers, {cfg.param_count() / 1e9:.3f} B "
            f"params; state {torch.cuda.memory_allocated() / 1e9:.2f} GB before the first "
            f"step")
        ops.reset_launch_counts()
        losses, norms, ms, copy_ms, host_ms = [], [], [], [], []
        for _ in range(steps):
            t0 = time.monotonic()
            batch = ds.next_batch()
            host_ms.append((time.monotonic() - t0) * 1e3)
            torch.cuda.synchronize()
            t0 = time.monotonic()
            torch.as_tensor(batch["inputs"], device="cuda")
            torch.cuda.synchronize()
            copy_ms.append((time.monotonic() - t0) * 1e3)
            t0 = time.monotonic()
            state, metrics = step(state, batch)
            torch.cuda.synchronize()
            ms.append((time.monotonic() - t0) * 1e3)
            losses.append(metrics["loss"].item())
            norms.append(metrics["grad_norm"].item())
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated() / 1e9
        if batch["inputs"].shape != (TRAIN_B, TRAIN_S, cfg.d_model):
            raise AssertionError(f"{name}: batch inputs {batch['inputs'].shape}")
        if not (np.isfinite(losses).all() and np.isfinite(norms).all() and min(norms) > 0):
            raise AssertionError(f"{name}: losses {losses}, grad norms {norms}")
        mu = state["opt"]["mu"]
        if mu["embed"].abs().max().item() != 0:
            raise AssertionError(f"{name}: the unread embedding table has a gradient")
        zero = [t for t in tree_leaves(mu)
                if t is not mu["embed"] and not t.abs().max().item() > 0]
        if zero:
            raise AssertionError(f"{name}: {len(zero)} leaves have a zero gradient")
        _require_launches(name, counts, TRAIN_KERNELS)
        want = {"flash_attention_fwd": 2 * cfg.num_layers * steps,
                "flash_attention_bwd": cfg.num_layers * steps}
        got = {k: counts[k]["cuda"] for k in want}
        if got != want:
            raise AssertionError(f"{name}: flash launches {got}, expected {want}")
        log(f"{name} ({arch}, {cfg.num_layers} layers, full width, remat full; fp32 params + "
            f"AdamW, bf16 compute, B={TRAIN_B} x S={TRAIN_S} embeddings of "
            f"{cfg.d_model}): steps " + ", ".join(f"{t:.1f}" for t in ms)
            + " ms; batch host -> device copy " + ", ".join(f"{t:.1f}" for t in copy_ms)
            + f" ms ({batch['inputs'].nbytes / 1e6:.1f} MB), batch made on the host in "
            + ", ".join(f"{t:.1f}" for t in host_ms) + " ms; losses "
            + ", ".join(f"{x:.4f}" for x in losses) + "; grad norms "
            + ", ".join(f"{x:.4f}" for x in norms) + f"; peak device memory {peak:.2f} GB; "
            f"flash launches {json.dumps(got)}; phase {time.monotonic() - t_phase:.1f}s")
        del state, step, mu
        _end_phase(name)
        out[label] = {k: c["cuda"] for k, c in counts.items()}
    return out


# ---------------------------------------------------------------------------
# 22. falcon-mamba train, 23. recurrent spec parity, 24. recurrent spec serve
# ---------------------------------------------------------------------------

#: falcon-mamba-7b's training depth on one card: 24 of 64 layers at full
#: width (2.79 B parameters, 44.7 GB of fp32 params, gradients and AdamW
#: moments; full depth would need 112 GB)
FALCON_TRAIN_LAYERS = 24
#: the scan kernels of the Mamba1 training path
SSM_TRAIN_KERNELS = ("ssm_scan", "ssm_scan_bwd")


def _falcon_train_parity():
    """falcon-mamba-7b at 2 layers, full width, fp32: ``lm_loss`` (B=2,
    S=200) and every gradient with impl="cuda" (the scan kernel with
    checkpoints and the backward kernel) against impl="torch" (autograd of
    the plain scan), the loss within 1e-4 and each gradient within
    GRAD_RTOL_FP32 of its largest value; the cuda run launches each scan
    kernel once a layer, the plain versions never."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_leaves, tree_unflatten

    cfg = dataclasses.replace(configs.get_config("falcon-mamba-7b"), num_layers=2)
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    rng = np.random.default_rng(21)
    toks = torch.tensor(rng.integers(0, cfg.vocab_size, (2, 201)), device="cuda")
    res = {}
    for impl in ("cuda", "torch"):
        leaves = [p.detach().clone().requires_grad_() for p in tree_leaves(params)]
        ops.reset_launch_counts()
        loss, _ = T.lm_loss(cfg, tree_unflatten(params, leaves), toks[:, :-1], toks[:, 1:],
                            impl=impl, compute_dtype=torch.float32)
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        res[impl] = (loss.item(), grads, ops.launch_counts())
    want = {"ssm_scan": {"cuda": cfg.num_layers, "torch": 0},
            "ssm_scan_bwd": {"cuda": cfg.num_layers, "torch": 0}}
    got = {n: res["cuda"][2][n] for n in want}
    if got != want:
        raise AssertionError(f"falcon train parity: cuda launches {got}, expected {want}")
    loss_err = abs(res["cuda"][0] - res["torch"][0])
    grad_err = max(((k - p).abs().max() / p.abs().max()).item()
                   for k, p in zip(res["cuda"][1], res["torch"][1]))
    if not (np.isfinite(res["cuda"][0]) and loss_err <= 1e-4 and grad_err <= GRAD_RTOL_FP32):
        raise AssertionError(f"falcon train parity: loss {res['cuda'][0]} vs "
                             f"{res['torch'][0]}, worst gradient error {grad_err}")
    log(f"falcon train parity (falcon-mamba-7b, 2 layers, full width, fp32, B=2, S=200): loss "
        f"{res['cuda'][0]:.6f} cuda vs {res['torch'][0]:.6f} torch (|d| {loss_err:.2e}, tol "
        f"1e-4); worst gradient max err / max|g| {grad_err:.2e} over "
        f"{len(res['cuda'][1])} leaves (tol {GRAD_RTOL_FP32:g}); cuda launches {json.dumps(got)}")


def phase_falcon_train():
    """falcon-mamba-7b trained on the card: ``_falcon_train_parity`` (2
    layers, cuda vs torch), then ``FALCON_TRAIN_LAYERS`` of 64 layers at
    full width under remat "full": fp32 params and AdamW, bf16 compute,
    batch 4 x seq 1024 Zipf tokens, 3 steps; finite losses and gradient
    norms, the peak memory, and per layer and step 2 forward scans (the
    recompute) and 1 backward.  Returns the second run's launch counts."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.configs import TrainConfig
    from repro_torch.data import SyntheticDataset
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.runtime import init_train_state, make_train_step
    from repro_torch.tree import tree_leaves

    _fresh_phase()
    _falcon_train_parity()
    _fresh_phase()
    cfg = dataclasses.replace(configs.get_config("falcon-mamba-7b"),
                              num_layers=FALCON_TRAIN_LAYERS)
    steps = 3
    state = init_train_state(T.init_params(cfg, torch.Generator(device="cuda").manual_seed(0)))
    step = make_train_step(cfg, TrainConfig(warmup_steps=2, total_steps=steps + 2,
                                            remat_policy="full"))
    ds = SyntheticDataset(cfg, seq_len=TRAIN_S, global_batch=TRAIN_B, seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in tree_leaves(state["params"]))
    log(f"falcon train: falcon-mamba-7b at {cfg.num_layers} of 64 layers, full width, "
        f"{n_params / 1e9:.3f} B params; state {torch.cuda.memory_allocated() / 1e9:.2f} GB "
        f"before the first step")
    ops.reset_launch_counts()
    losses, norms, ms = [], [], []
    for _ in range(steps):
        batch = ds.next_batch()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        ms.append((time.monotonic() - t0) * 1e3)
        losses.append(metrics["loss"].item())
        norms.append(metrics["grad_norm"].item())
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    if not (np.isfinite(losses).all() and np.isfinite(norms).all() and min(norms) > 0):
        raise AssertionError(f"falcon train: losses {losses}, grad norms {norms}")
    _require_launches("falcon train", counts, SSM_TRAIN_KERNELS)
    want = {"ssm_scan": 2 * cfg.num_layers * steps, "ssm_scan_bwd": cfg.num_layers * steps}
    got = {name: counts[name]["cuda"] for name in want}
    if got != want:
        raise AssertionError(f"falcon train: scan launches {got}, expected {want}")
    log(f"falcon train (falcon-mamba-7b, {cfg.num_layers} of 64 layers, full width, remat "
        f"full; fp32 params + AdamW, bf16 compute, B={TRAIN_B} x S={TRAIN_S}): steps "
        + ", ".join(f"{t:.1f}" for t in ms) + " ms; losses "
        + ", ".join(f"{x:.4f}" for x in losses) + "; grad norms "
        + ", ".join(f"{x:.4f}" for x in norms) + f"; peak device memory {peak:.2f} GB; scan "
        f"launches {json.dumps(got)} (2 forward, 1 backward a layer and step)")
    del state, step
    _end_phase("falcon train")
    return {"falcon_train": {name: c["cuda"] for name, c in counts.items()}}


def phase_recurrent_spec_parity():
    """Speculation with a recurrent target and draft on the card:
    falcon-mamba-7b at 2 layers and zamba2-2.7b at ``HYBRID_PARITY_LAYERS``
    of 54, full width, fp32, each paired with ``draft_config``'s draft
    (random weights, so most drafts are rejected and the state rollback
    runs), ``proposer="auto"`` (the draft alone: host proposers need an
    attention target).  The speculating engine's streams with impl="cuda"
    equal impl="torch"'s and the plain greedy engine's; drafted > accepted;
    the cuda engine launches the scan (falcon-mamba's prefills) or the flash
    and dense decode kernels (zamba2), the plain versions never."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.configs import SpecDecodeConfig, draft_config
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import InferenceEngine

    for arch, layers, kernels in (("falcon-mamba-7b", 2, SSM_KERNELS),
                                  ("zamba2-2.7b", HYBRID_PARITY_LAYERS, HYBRID_SERVE_KERNELS)):
        _fresh_phase()
        cfg = dataclasses.replace(configs.get_config(arch), num_layers=layers)
        spec = SpecDecodeConfig(proposer="auto")
        dcfg = draft_config(cfg, spec)
        params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
        dparams = T.init_params(dcfg, torch.Generator(device="cuda").manual_seed(1))
        prompts = _prompts(np.random.default_rng(23), 6, 24, 80, cfg.vocab_size, 0, ())
        streams, stats = {}, {}
        for name, impl in (("plain", "cuda"), ("spec", "cuda"), ("spec", "torch")):
            kw = {} if name == "plain" else dict(draft_cfg=dcfg, draft_params=dparams,
                                                 spec=spec)
            eng = InferenceEngine(cfg, params, max_slots=4, max_seq=256,
                                  compute_dtype=torch.float32, decode_impl=impl, **kw)
            ops.reset_launch_counts()
            reqs, secs = _serve(eng, prompts, max_new=12)
            counts = ops.launch_counts()
            streams[name, impl] = [list(r.output_tokens) for r in reqs]
            stats[name, impl] = (eng.spec_rounds, eng.spec_drafted, eng.spec_accepted)
            if name == "spec" and impl == "cuda":
                _require_launches(f"{arch} spec parity", counts, kernels)
                launched = {k: counts[k]["cuda"] for k in kernels}
            del eng
        if not streams["spec", "cuda"] == streams["spec", "torch"] == streams["plain", "cuda"]:
            raise AssertionError(f"{arch} spec parity: streams differ (cuda, torch, plain)")
        rounds, drafted, accepted = stats["spec", "cuda"]
        if stats["spec", "cuda"] != stats["spec", "torch"] or not drafted > accepted:
            raise AssertionError(f"{arch} spec parity: rounds / drafted / accepted "
                                 f"{stats['spec', 'cuda']} vs {stats['spec', 'torch']}")
        log(f"recurrent spec parity ({arch}, {layers} layers, full width, fp32, draft "
            f"{dcfg.num_layers} layers d_model {dcfg.d_model}): {len(prompts)} requests x 12 "
            f"tokens, streams equal cuda == torch == plain greedy; rounds / drafted / "
            f"accepted {stats['spec', 'cuda']}; cuda launches {json.dumps(launched)}")
        del params, dparams
        _end_phase(f"{arch} spec parity")


def phase_recurrent_spec_serve():
    """falcon-mamba-7b and zamba2-2.7b at full depth and width, bf16
    weights made on the card, 8 slots, max_seq 512, paired with
    ``draft_config``'s draft, ``proposer="auto"``: the ssm serve's 16 ONLINE
    requests of 25-157 tokens, 32 new tokens each.  Every request finishes;
    tok/s, TTFT, acceptance and peak memory reported; falcon-mamba's
    prefills launch the scan once per layer of target and draft and
    admission, zamba2's the flash forward once per cycle of each and
    admission, and its decode steps the dense decode.  Returns the launch
    counts by run."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.configs import SpecDecodeConfig, draft_config
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import InferenceEngine

    out = {}
    for run, arch in (("falcon_spec_serve", "falcon-mamba-7b"),
                      ("zamba2_spec_serve", "zamba2-2.7b")):
        _fresh_phase()
        cfg = configs.get_config(arch)
        spec = SpecDecodeConfig(proposer="auto")
        dcfg = draft_config(cfg, spec)
        t0 = time.monotonic()
        params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                               dtype=torch.bfloat16)
        dparams = T.init_params(dcfg, torch.Generator(device="cuda").manual_seed(1),
                                dtype=torch.bfloat16)
        t_start = time.monotonic()
        engine = InferenceEngine(cfg, params, max_slots=8, max_seq=512, draft_cfg=dcfg,
                                 draft_params=dparams, spec=spec,
                                 clock=lambda: time.monotonic() - t_start)
        del params, dparams
        torch.cuda.synchronize()
        rng = np.random.default_rng(4)
        prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
                   for n in rng.integers(25, 158, 16)]
        max_new = 32
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        reqs, secs = _serve(engine, prompts, max_new)
        counts = ops.launch_counts()
        _check_finished(f"{arch} spec serve", reqs, max_new, cfg)
        admissions = len(prompts) + sum(r.preemptions for r in reqs)
        if cfg.family == "ssm":
            kernels = SSM_KERNELS
            want = {"ssm_scan": (cfg.num_layers + dcfg.num_layers) * admissions}
        else:
            kernels = HYBRID_SERVE_KERNELS
            n_cyc = (cfg.num_layers + dcfg.num_layers) // cfg.shared_attn_every
            want = {"flash_attention_fwd": n_cyc * admissions}
        _require_launches(f"{arch} spec serve", counts, kernels)
        got = {name: counts[name]["cuda"] for name in want}
        if got != want:
            raise AssertionError(f"{arch} spec serve: launches {got}, expected {want}")
        if engine.spec_rounds <= 0 or not engine.spec_drafted > engine.spec_accepted:
            raise AssertionError(f"{arch} spec serve: rounds {engine.spec_rounds}, drafted "
                                 f"{engine.spec_drafted}, accepted {engine.spec_accepted}")
        tokens = sum(len(r.output_tokens) for r in reqs)
        launched = {k: counts[k]["cuda"] for k in kernels}
        log(f"{arch} spec serve (full depth, bf16, draft {dcfg.num_layers} layers d_model "
            f"{dcfg.d_model}, proposer auto): set-up {t_start - t0:.1f}s; prompts "
            f"{min(map(len, prompts))}-{max(map(len, prompts))} tokens; "
            f"{_serve_summary(engine.obs.metrics, reqs, tokens, secs)}; spec rounds "
            f"{engine.spec_rounds}, drafted {engine.spec_drafted}, accepted "
            f"{engine.spec_accepted} (acceptance {engine.spec_acceptance_rate:.3f}); "
            f"launches {json.dumps(launched)}")
        out[run] = {name: c["cuda"] for name, c in counts.items()}
        del engine
        _end_phase(f"{arch} spec serve")
    return out


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# 25. olmo parity, 26. olmo serve (``phase_config_serves(OLMO_SERVES)``),
# 27. olmo train (the training CLI and the Trainer)
# ---------------------------------------------------------------------------

#: the CLI's training run: olmo-1b at full depth, 6 steps
OLMO_TRAIN_STEPS = 6
#: the Trainer cycle's depth: 2 of 16 layers at full width (a checkpoint of
#: its fp32 params, AdamW moments and error-feedback buffers is ~3.8 GB; at
#: full depth it would be ~19 GB)
OLMO_CYCLE_LAYERS = 2
#: the cycle's losses after the restore against the uninterrupted run's: the
#: same kernels on the same inputs from the same state
OLMO_RESUME_RTOL = 1e-6


def phase_olmo_parity():
    """olmo-1b at 2 layers, full width, fp32, impl="cuda" against
    impl="torch": ``_model_step_parity``; EngineCore streams on the paged
    layout equal, the cuda engine launching both paged kernels (its decode
    graphs one paged decode a layer and step); ``lm_loss`` (B=2, S=256)
    within 1e-5 relative and every gradient within GRAD_RTOL_FP32 of its
    largest value, the cuda run launching flash once a layer each way."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import InferenceEngine
    from repro_torch.tree import tree_leaves, tree_unflatten

    t_phase = time.monotonic()
    _fresh_phase()
    cfg = dataclasses.replace(configs.get_config("olmo-1b"), num_layers=2)
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    rng = np.random.default_rng(25)
    _model_step_parity("olmo parity model", cfg, params, rng)

    streams = {}
    for impl in ("cuda", "torch"):
        eng = InferenceEngine(cfg, params, max_slots=4, max_seq=256,
                              compute_dtype=torch.float32, decode_impl=impl)
        prompts = _prompts(np.random.default_rng(26), 6, 24, 80, cfg.vocab_size,
                           shared_prefix=32, shared_idx=(0, 5))
        ops.reset_launch_counts()
        reqs, _ = _serve(eng, prompts, max_new=8)
        streams[impl] = [list(r.output_tokens) for r in reqs]
        if impl == "cuda":
            _require_launches("olmo parity engine", ops.launch_counts(), SERVE_KERNELS)
            graphs = _decode_graph_launches("olmo parity engine", eng, cfg)
        del eng
    if streams["cuda"] != streams["torch"]:
        raise AssertionError("olmo parity: EngineCore token streams differ (cuda vs torch)")
    log(f"olmo parity engine: {len(streams['cuda'])} requests, token streams equal; the "
        f"cuda engine's decode graphs captured {graphs} paged decode launches (k: launches)")

    toks = torch.tensor(rng.integers(0, cfg.vocab_size, (2, 257)), dtype=torch.int32,
                        device="cuda")
    res = {}
    for impl in ("cuda", "torch"):
        leaves = [p.detach().clone().requires_grad_() for p in tree_leaves(params)]
        ops.reset_launch_counts()
        loss, _ = T.lm_loss(cfg, tree_unflatten(params, leaves), toks[:, :-1], toks[:, 1:],
                            impl=impl, compute_dtype=torch.float32)
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        res[impl] = (loss.detach(), grads, ops.launch_counts())
    _require_launches("olmo parity train", res["cuda"][2], TRAIN_KERNELS)
    got = {n: res["cuda"][2][n]["cuda"] for n in TRAIN_KERNELS}
    if got != {n: cfg.num_layers for n in TRAIN_KERNELS}:
        raise AssertionError(f"olmo parity train: flash launches {got}, one a layer expected")
    loss_err = (res["cuda"][0] - res["torch"][0]).abs().item()
    grad_err = max(((a - b).abs().max() / b.abs().max()).item()
                   for a, b in zip(res["cuda"][1], res["torch"][1]))
    if not (torch.isfinite(res["cuda"][0]) and loss_err <= 1e-5 * res["torch"][0].abs().item()):
        raise AssertionError(f"olmo parity: lm_loss differs by {loss_err}")
    if not grad_err <= GRAD_RTOL_FP32:
        raise AssertionError(f"olmo parity: gradients differ by {grad_err} of max|g|")
    log(f"olmo parity train (2 layers, full width, fp32, B=2, S=256): loss "
        f"{res['torch'][0].item():.6f}, |d| {loss_err:.2e} (tol 1e-5 relative); gradients "
        f"max err / max|g| {grad_err:.2e} over {len(res['cuda'][1])} leaves (tol "
        f"{GRAD_RTOL_FP32:g}); cuda launches {json.dumps(got)}")
    del params, res
    _end_phase("olmo parity")
    log(f"olmo parity: {time.monotonic() - t_phase:.1f}s")


def _olmo_cli_runs():
    """The training CLI at olmo-1b's full depth, plain and ``--collocate``;
    returns {run label: launch counts}."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_cli

    cfg = configs.get_config("olmo-1b")
    argv = ["--arch", "olmo-1b", "--seq-len", str(TRAIN_S), "--global-batch", str(TRAIN_B),
            "--steps", str(OLMO_TRAIN_STEPS)]
    out = {}
    for label, extra in (("olmo_train", []), ("olmo_collocate", ["--collocate"])):
        name = label.replace("_", " ")
        _fresh_phase()
        ops.reset_launch_counts()
        t0 = time.monotonic()
        result = train_cli.main(argv + extra)
        torch.cuda.synchronize()
        secs = time.monotonic() - t0
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated() / 1e9
        if extra:
            # measure_dp_profile's two calibration steps train too
            losses, steps = result.train_losses, result.train_iterations + 2
            kernels = TRAIN_KERNELS + SERVE_KERNELS
            detail = (f"{result.offline_tokens_generated} offline tokens in "
                      f"{result.offline_microsteps} microsteps; phases "
                      f"{json.dumps(result.phase_counts)}")
            if not result.offline_tokens_generated > 0:
                raise AssertionError(f"{name}: no offline tokens in the bubbles")
        else:
            losses, steps = result.losses, result.steps
            kernels = TRAIN_KERNELS
            detail = "steps " + ", ".join(f"{t * 1e3:.1f}" for t in result.step_times_s) + " ms"
        if len(losses) != OLMO_TRAIN_STEPS or not np.isfinite(losses).all():
            raise AssertionError(f"{name}: losses {losses}")
        _require_launches(name, counts, kernels)
        want = {"flash_attention_fwd": 2 * cfg.num_layers * steps,
                "flash_attention_bwd": cfg.num_layers * steps}
        got = {n: counts[n]["cuda"] for n in want}
        if got != want:
            raise AssertionError(f"{name}: flash launches {got}, expected {want} (remat "
                                 f"full: forward twice, backward once a layer and step)")
        log(f"{name} (olmo-1b CLI, full depth, {cfg.param_count() / 1e9:.3f} B params, fp32 "
            f"+ AdamW, bf16 compute, remat full, B={TRAIN_B} x S={TRAIN_S}): {secs:.1f}s "
            f"(set-up included); {detail}; losses " + ", ".join(f"{x:.4f}" for x in losses)
            + f"; peak device memory {peak:.2f} GB; launches "
            f"{json.dumps({k: v['cuda'] for k, v in counts.items() if v['cuda']})}")
        out[label] = {n: c["cuda"] for n, c in counts.items()}
        del result
        _end_phase(name)
    return out


def _olmo_trainer_cycle():
    """The ``Trainer`` at ``OLMO_CYCLE_LAYERS`` of 16 layers, full width,
    ``grad_compression="int8_ef"``, remat "full", 4 x 1024: an uninterrupted
    run of ``OLMO_TRAIN_STEPS`` on the eager step with every EF call
    checked (``deq + err_new == g + err_old`` exactly), then the same run
    on the Trainer's ``jitted()`` step, checkpointing every 4 steps into a
    temporary directory with a failure injected at step 5: one restore,
    one capture, the losses bit-equal to the uninterrupted run's (and
    within OLMO_RESUME_RTOL)."""
    import tempfile

    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.configs import TrainConfig
    from repro_torch.optim import ef_int8_compress_decompress
    from repro_torch.runtime import Trainer
    from repro_torch.runtime import step as step_module
    from repro_torch.tree import tree_leaves

    _fresh_phase()
    cfg = dataclasses.replace(configs.get_config("olmo-1b"), num_layers=OLMO_CYCLE_LAYERS)
    tcfg = TrainConfig(warmup_steps=2, total_steps=OLMO_TRAIN_STEPS + 2, remat_policy="full",
                       grad_compression="int8_ef")
    kw = dict(seq_len=TRAIN_S, global_batch=TRAIN_B)

    ef_errs = []

    def checked_ef(g, err):
        want = g.float() + err  # before the step writes the new residual
        deq, new_err = ef_int8_compress_decompress(g, err)
        ef_errs.append((deq + new_err - want).abs().max().item())
        return deq, new_err

    step_module.ef_int8_compress_decompress = checked_ef
    try:
        clean = Trainer(cfg, tcfg, **kw)
        # the check reads each call's error on the host, which a captured
        # step cannot: the uninterrupted run is the eager step, and the
        # checkpointed run below the Trainer's graphed one
        clean.step_fn = clean.art
        clean_report = clean.train(OLMO_TRAIN_STEPS)
    finally:
        step_module.ef_int8_compress_decompress = ef_int8_compress_decompress
    n_leaves = len(tree_leaves(clean.state["params"]))
    if len(ef_errs) != n_leaves * OLMO_TRAIN_STEPS or max(ef_errs) != 0.0:
        raise AssertionError(f"olmo trainer: EF identity off by {max(ef_errs)} over "
                             f"{len(ef_errs)} calls ({n_leaves} leaves x {OLMO_TRAIN_STEPS})")

    with tempfile.TemporaryDirectory(prefix="olmo_ckpt_") as ckpt_dir:
        trainer = Trainer(cfg, tcfg, checkpoint_dir=ckpt_dir, checkpoint_every=4, **kw)
        ck = trainer.ckpt
        ck.keep = 2  # the disk holds two ~3.8 GB checkpoints and one being written
        saves, restores = [], []
        save, restore = ck.save, ck.restore

        def timed_save(step, tree, blocking=True):
            t0 = time.monotonic()
            save(step, tree, blocking=blocking)
            saves.append((step, blocking, time.monotonic() - t0))

        def timed_restore(template=None, step=None):
            t0 = time.monotonic()
            got = restore(template, step)
            restores.append(time.monotonic() - t0)
            return got

        ck.save, ck.restore = timed_save, timed_restore
        fired = []

        def fail_once_at_5(step_no):
            if step_no == 5 and not fired:
                fired.append(step_no)
                return True
            return False

        trainer.fail_hook = fail_once_at_5
        report = trainer.train(OLMO_TRAIN_STEPS)
        ckpt_bytes = os.path.getsize(
            os.path.join(ckpt_dir, f"step_{ck.latest_step():08d}", "arrays.npz"))
    if fired != [5] or report.restores != 1 or len(restores) != 1:
        raise AssertionError(f"olmo trainer: fired {fired}, restores {report.restores}")
    # steps 0-4, then step 4 again from its checkpoint, then step 5
    ours = np.array(report.losses)
    ref = np.array(clean_report.losses[:5] + clean_report.losses[4:])
    rel = float(np.max(np.abs(ours - ref) / np.abs(ref)))
    if not (np.isfinite(ours).all() and rel <= OLMO_RESUME_RTOL):
        raise AssertionError(f"olmo trainer: losses {report.losses} against the "
                             f"uninterrupted {clean_report.losses} ({rel:.2e} relative)")
    bit_equal = report.losses == clean_report.losses[:5] + clean_report.losses[4:]
    captures = trainer.step_fn.graphs.captures
    if not bit_equal or captures != 1:
        raise AssertionError(f"olmo trainer: the graphed run's losses {report.losses} against "
                             f"the eager {clean_report.losses} ({captures} captures)")
    state_err = max(((a - b).abs().max() / b.abs().max().clamp(min=1e-30)).item()
                    for a, b in zip(tree_leaves(trainer.state["params"]),
                                    tree_leaves(clean.state["params"])))
    log(f"olmo trainer (olmo-1b at {cfg.num_layers} of 16 layers, full width, int8_ef, remat "
        f"full, B={TRAIN_B} x S={TRAIN_S}): uninterrupted losses "
        + ", ".join(f"{x:.6f}" for x in clean_report.losses) + "; steps "
        + ", ".join(f"{t * 1e3:.1f}" for t in clean_report.step_times_s)
        + f" ms; EF identity exact over {len(ef_errs)} leaf calls; failure at step 5 -> "
        f"restored step 4, losses after the restore max rel diff {rel:.2e} (tol "
        f"{OLMO_RESUME_RTOL:g}), bit-equal {bit_equal} (the graphed step, {captures} capture, "
        f"against the eager); final params max rel diff "
        f"{state_err:.2e}; straggler events {report.straggler_events}")
    log(f"olmo trainer checkpoints: {ckpt_bytes / 1e9:.3f} GB each (arrays.npz); saves "
        + ", ".join(f"step {s} {'blocking' if b else 'async (host copy)'} {t:.2f}s"
                    for s, b, t in saves)
        + f"; restore {restores[0]:.2f}s")
    del clean, trainer
    _end_phase("olmo trainer")


def phase_olmo_train():
    """Phase 27: ``_olmo_cli_runs``, then ``_olmo_trainer_cycle``.  Returns
    {run label: launch counts} of the CLI runs."""
    t_phase = time.monotonic()
    out = _olmo_cli_runs()
    _olmo_trainer_cycle()
    log(f"olmo train: {time.monotonic() - t_phase:.1f}s")
    return out


# ---------------------------------------------------------------------------
# 29. online serving at full width
# ---------------------------------------------------------------------------

#: the online example's iterations and Poisson ONLINE requests
ONLINE_ITERS = ONLINE_REQUESTS = 12


def phase_online_serving():
    """Phase 29: ``examples/torch_online_serving.py``'s ``run`` at olmo-1b's
    full depth and width (phases 25-27's config; fp32 params + AdamW, bf16
    compute, remat "full", B=4 x S=1024) over the profile and microstep
    ``measure_dp_profile`` takes here, ``ONLINE_ITERS`` iterations under
    ``SpecInFRuntime`` with ``busy_hold_ms=5``, ``ONLINE_REQUESTS`` Poisson
    ONLINE arrivals.  Asserts: every request served, finite losses, the
    paged decode and prefill and the flash forward and backward launched
    (plain versions never).  Prints p95 latency / TTFT (virtual), the wall
    time and the peak memory.  Returns the run's launch counts."""
    import importlib.util

    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.configs import TrainConfig
    from repro_torch.kernels import ops

    spec = importlib.util.spec_from_file_location(
        "torch_online_serving", os.path.join(ROOT, "examples", "torch_online_serving.py"))
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    cfg = configs.get_config("olmo-1b")
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=2, total_steps=ONLINE_ITERS + 2,
                       remat_policy="full")
    _fresh_phase()
    ops.reset_launch_counts()
    t0 = time.monotonic()
    m, reqs, profile, microstep_s = example.run(
        cfg, "cuda", tcfg=tcfg, seq_len=TRAIN_S, global_batch=TRAIN_B, max_seq=256,
        iterations=ONLINE_ITERS, num_requests=ONLINE_REQUESTS)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts = ops.launch_counts()
    losses = m.train_losses
    if not (m.online_served == len(reqs) == ONLINE_REQUESTS
            and all(r.state.finished and len(r.output_tokens) == 4 for r in reqs)):
        raise AssertionError(f"online serving: {m.online_served} of {len(reqs)} served")
    if len(losses) != ONLINE_ITERS or not np.isfinite(losses).all():
        raise AssertionError(f"online serving: losses {losses}")
    _require_launches("online serving", counts, SERVE_KERNELS + TRAIN_KERNELS)
    log(f"online serving (olmo-1b, full depth, remat full, B={TRAIN_B} x S={TRAIN_S}, "
        f"busy_hold_ms 5): {m.online_served}/{len(reqs)} served; p95 latency "
        f"{m.p95_latency_s() * 1e3:.3f} ms, p95 TTFT {m.p95_ttft_s() * 1e3:.3f} ms (virtual); "
        f"measured train step {profile.compute_s * 1e3:.1f} ms, microstep "
        f"{microstep_s * 1e3:.3f} ms (2 slots); {m.offline_tokens_generated} offline tokens; "
        f"phases {json.dumps(m.phase_counts)}; losses "
        + ", ".join(f"{x:.4f}" for x in losses)
        + f"; virtual {m.virtual_time_s:.3f}s; wall {wall:.1f}s (set-up and two calibration "
        f"steps included); peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB;"
        f" launches {json.dumps({k: v['cuda'] for k, v in counts.items() if v['cuda']})}")
    del m, reqs
    _end_phase("online serving")
    return {n: c["cuda"] for n, c in counts.items()}


# ---------------------------------------------------------------------------
# 30. the sharded train step at world size 1 over NCCL, 31. the fused
# collocated step
# ---------------------------------------------------------------------------

#: phase 30's steps on each side (then one more after the remesh)
SCALE_STEPS = 3
#: phase 31's decode chain lengths, its dense rows (8 slots of 512) and the
#: lengths they hold when the chain starts
COLLOC_KS = (0, 2, 8)
COLLOC_SLOTS, COLLOC_MAX_SEQ = 8, 512
COLLOC_LENGTHS = (100, 200, 37, 500, 1, 256, 64, 300)
#: F1's cycles: phase 31's fused calls, each k on a fresh cache of the one
#: shape, and phase 33's prefill -> decode cycles through ``jitted()``
F1_CYCLES = 5
#: device memory allocated after each such cycle (the Trainer's after its
#: remesh round trip) may differ from the first's by at most this much: a
#: graph that kept its cache or state alive would leave 0.27-20 GB behind;
#: a few incidental blocks (a collective's) may come and go
FLAT_BYTES = 1 << 20


def _timed(fn, *args):
    """``(fn(*args), seconds)`` between two device synchronisations."""
    import torch

    torch.cuda.synchronize()
    t0 = time.monotonic()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, time.monotonic() - t0


def _equal_trees(label, got, want):
    """Every leaf of ``got`` bit-equal to ``want``'s."""
    import torch

    from repro_torch.tree import tree_leaves

    a, b = tree_leaves(got), tree_leaves(want)
    if len(a) != len(b):
        raise AssertionError(f"{label}: {len(a)} leaves against {len(b)}")
    bad = [i for i, (x, y) in enumerate(zip(a, b)) if not torch.equal(x.detach(), y.detach())]
    if bad:
        raise AssertionError(f"{label}: leaves {bad} of {len(a)} differ")
    return len(a)


def phase_sharded_step(mesh):
    """Phase 30: olmo-1b at full width and depth under the train CLI's
    non-smoke settings (FSDP, ZeRO-1, remat "full", fp32 params + AdamW,
    bf16 compute, 4 x 1024 tokens) through a ``Trainer`` on ``mesh`` (one
    rank over NCCL: every collective an identity), ``SCALE_STEPS`` steps
    from the seed's state and batches against ``make_train_step(cfg,
    tcfg)`` without a mesh: losses, grad norms and every parameter and
    moment bit-equal.  Then ``Trainer.remesh`` onto a ("pod", "data") =
    (1, 1) mesh and one more step on each side, bit-equal.  Prints both
    step times, the peak memory (both states resident), the collectives of
    each sharded step.  Returns ``(launch counts of the sharded steps,
    trainer)``."""
    import torch

    from repro_torch import configs
    from repro_torch.configs import TrainConfig
    from repro_torch.data import SyntheticDataset
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as T
    from repro_torch.runtime import Trainer, init_train_state, make_train_step

    t_phase = time.monotonic()
    _fresh_phase()
    cfg = configs.get_config("olmo-1b")
    tcfg = TrainConfig(warmup_steps=2, total_steps=SCALE_STEPS + 8, remat_policy="full",
                       fsdp=True, zero1=True)
    trainer = Trainer(cfg, tcfg, mesh, seq_len=TRAIN_S, global_batch=TRAIN_B)
    plain = make_train_step(cfg, tcfg)
    gen = torch.Generator(device="cuda").manual_seed(tcfg.seed)
    state = init_train_state(T.init_params(cfg, gen), tcfg)
    ds = SyntheticDataset(cfg=cfg, seq_len=TRAIN_S, global_batch=TRAIN_B, seed=tcfg.seed)
    batches = [ds.next_batch() for _ in range(SCALE_STEPS + 1)]

    plain_m, plain_t = [], []
    for b in batches[:SCALE_STEPS]:
        (state, m), dt = _timed(plain, state, b)
        plain_m.append(m)
        plain_t.append(dt)
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    sharded_m, sharded_t, colls = [], [], []
    for _ in range(SCALE_STEPS):
        (trainer.state, m), dt = _timed(trainer.step_fn, trainer.state, trainer._batch())
        sharded_m.append(m)
        sharded_t.append(dt)
        colls.append(dict(trainer.step_fn.last_collectives))
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    for i, (a, b) in enumerate(zip(sharded_m, plain_m)):
        _equal_trees(f"scale out step {i} metrics", a, b)
    n_leaves = _equal_trees("scale out state", trainer.state, state)
    _require_launches("scale out", counts, TRAIN_KERNELS)
    want = {"flash_attention_fwd": 2 * cfg.num_layers * SCALE_STEPS,
            "flash_attention_bwd": cfg.num_layers * SCALE_STEPS}
    got = {n: counts[n]["cuda"] for n in want}
    if got != want:
        raise AssertionError(f"scale out: flash launches {got}, expected {want}")
    if not all(c == colls[0] and c.get("all_reduce") for c in colls):
        raise AssertionError(f"scale out: collectives a step {colls}")

    live = trainer.state
    trainer.remesh(make_mesh((1, 1), ("pod", "data"), device="cuda"))
    if trainer.state is not live:
        raise AssertionError("scale out: remesh replaced the state's dict")
    (state, m), _ = _timed(plain, state, batches[SCALE_STEPS])
    report = trainer.train(1)
    if report.losses != [m["loss"].item()]:
        raise AssertionError(f"scale out: after remesh loss {report.losses} against "
                             f"{m['loss'].item()}")
    _equal_trees("scale out state after remesh", trainer.state, state)
    log(f"scale out ({_card()}; olmo-1b full depth, {cfg.param_count() / 1e9:.3f} B params, "
        f"fp32 + AdamW, bf16 compute, remat full, FSDP + ZeRO-1, B={TRAIN_B} x S={TRAIN_S}, "
        f"mesh {mesh.shape} over NCCL): {SCALE_STEPS} steps bit-equal to the unsharded step "
        f"(losses " + ", ".join(f"{x['loss'].item():.6f}" for x in sharded_m)
        + ", grad norms " + ", ".join(f"{x['grad_norm'].item():.6f}" for x in sharded_m)
        + f"; {n_leaves} state leaves); step ms sharded "
        + ", ".join(f"{t * 1e3:.1f}" for t in sharded_t) + " / unsharded "
        + ", ".join(f"{t * 1e3:.1f}" for t in plain_t)
        + f"; peak device memory {peak:.2f} GB (both states resident); collectives a "
        f"step {json.dumps(colls[0])}; remesh onto {trainer.mesh.shape}: the next step's loss "
        f"{report.losses[0]:.6f} and state bit-equal, {report.step_times_s[0] * 1e3:.1f} ms; "
        f"launches {json.dumps(got)}")
    del state, plain_m, sharded_m
    _end_phase("scale out")
    log(f"scale out: {time.monotonic() - t_phase:.1f}s")
    return {n: c["cuda"] for n, c in counts.items()}, trainer


def phase_collocated_step(trainer):
    """Phase 31: ``make_collocated_step`` over phase 30's sharded step and
    k in ``COLLOC_KS`` greedy ``T.decode_step`` microsteps of the trainer's
    weights cast to bf16 (as an engine casts them) on dense rows
    (``COLLOC_SLOTS`` of ``COLLOC_MAX_SEQ``, random K / V at
    ``COLLOC_LENGTHS``), the chain on a second stream; the train step is
    the trainer's ``jitted()`` one (a graph replay).  Each k starts from
    the same state and batch, and each call takes a fresh cache of the one
    shape (which the chain's graph copies into its buffers): the train
    result (metrics, every parameter and moment) is bit-equal across k and
    to the step run alone, and the k-step tokens equal k eager decode
    steps'.  Then ``F1_CYCLES`` more rounds of fresh caches: the tokens
    equal, one capture and one live graph a k, device memory flat.
    Prints fused[k]'s time beside the step alone plus the k decode steps
    alone (the overlap; not asserted; the second of two rounds, each step
    and chain also timed alone in it).  Returns the timed round's fused
    launch counts."""
    import torch

    from repro_torch.core import make_collocated_step
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_map

    t_phase = time.monotonic()
    _fresh_phase()
    cfg = trainer.cfg
    state = trainer.state
    base = tree_map(lambda t: t.detach().clone(), state)
    infer = T.cast_params(tree_map(lambda t: t.detach().clone(), trainer.full_state()["params"]),
                          torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(31)
    cache0 = T.init_cache(cfg, COLLOC_SLOTS, COLLOC_MAX_SEQ, torch.bfloat16, device="cuda")
    for name in ("k", "v"):
        cache0["layers"][name].copy_(torch.randn(cache0["layers"][name].shape, generator=gen,
                                                 device="cuda"))
    cache0["index"] = torch.tensor(COLLOC_LENGTHS, dtype=torch.int32, device="cuda")
    tokens0 = torch.arange(1, COLLOC_SLOTS + 1, dtype=torch.int32, device="cuda")
    batch = trainer._batch()

    def decode(p, t, c):
        return T.decode_step(cfg, p, t, c, compute_dtype=torch.bfloat16)

    def fresh_cache():
        """A new cache of the one shape: a chain graph copies it into its
        own buffers and returns those (the reference's donated cache)."""
        return tree_map(lambda t: t.clone(), cache0)

    @torch.no_grad()
    def reset():
        tree_map(lambda live, b: live.copy_(b), state, base)

    def chain(k):
        t, c = tokens0, fresh_cache()
        for _ in range(k):
            logits, c = decode(infer, t, c)
            t = torch.argmax(logits, dim=-1).to(torch.int32)
        return t

    fused = make_collocated_step(trainer.step_fn, decode, k_buckets=COLLOC_KS)
    reset()
    (_, alone_m), alone_s = _timed(trainer.step_fn, state, batch)
    alone_m = {k: v.clone() for k, v in alone_m.items()}
    ref = tree_map(lambda t: t.detach().clone(), state)
    for attempt in range(2):  # the first round warms both streams up; the second is timed
        reset()
        _, alone_s = _timed(trainer.step_fn, state, batch)
        chains = {k: _timed(chain, k) for k in COLLOC_KS}
        ops.reset_launch_counts()
        rows = {}
        for k in COLLOC_KS:
            reset()
            (_, m, toks, _), rows[k] = _timed(fused[k], state, batch, infer, tokens0,
                                              fresh_cache())
            _equal_trees(f"collocated step k={k} metrics", m, alone_m)
            _equal_trees(f"collocated step k={k} state", state, ref)
            if not torch.equal(toks, chains[k][0]):
                raise AssertionError(f"collocated step k={k}: tokens {toks.tolist()} against "
                                     f"the eager chain's {chains[k][0].tolist()}")
        counts = ops.launch_counts()
    _require_launches("collocated step", counts, TRAIN_KERNELS + ("decode_attention",))
    want = {"flash_attention_fwd": 2 * cfg.num_layers * len(COLLOC_KS),
            "flash_attention_bwd": cfg.num_layers * len(COLLOC_KS),
            "decode_attention": cfg.num_layers * sum(COLLOC_KS)}
    got = {n: counts[n]["cuda"] for n in want}
    if got != want:
        raise AssertionError(f"collocated step: launches {got}, expected {want}")
    # F1: more calls, each k on a fresh cache of the one shape, the tokens
    # equal to the eager chain's, one graph a k, device memory flat
    f1 = []
    for _ in range(F1_CYCLES):
        for k in COLLOC_KS:
            reset()
            _, _, toks, _ = fused[k](state, batch, infer, tokens0, fresh_cache())
            if not torch.equal(toks, chains[k][0]):
                raise AssertionError(f"collocated step k={k}: tokens on a fresh cache "
                                     f"{toks.tolist()} against {chains[k][0].tolist()}")
        del toks
        gc.collect()
        torch.cuda.synchronize()
        f1.append((torch.cuda.memory_allocated(),
                   {k: (fused[k].graphs.captures, len(fused[k].graphs.graphs))
                    for k in COLLOC_KS if k}))
    captures = {k: fused[k].graphs.captures for k in COLLOC_KS if k}
    if any(c != {k: (1, 1) for k in captures} for _, c in f1) or any(
            abs(b - f1[0][0]) > FLAT_BYTES for b, _ in f1):
        raise AssertionError(f"collocated step: over {F1_CYCLES} cycles of fresh caches "
                             f"(allocated bytes, {{k: (captures, live graphs)}}) {f1}")
    log(f"collocated step F1: {2 + F1_CYCLES} calls a k, each on a fresh cache of one shape: "
        f"tokens equal to the eager chain's; (captures, live graphs) by k "
        f"{json.dumps(f1[-1][1])}; device memory allocated after each of the last "
        f"{F1_CYCLES}: " + ", ".join(str(b) for b, _ in f1) + " bytes")
    chain_rows = []
    for k in captures:
        reset()
        graph, = fused[k].graphs.graphs.values()
        chain_rows.append(_check_program(f"collocated step k={k}", ("chain", k), graph.prog,
                                         [(t, False) for t in graph.cache]))
    log(f"collocated step ({_card()}; phase 30's sharded olmo-1b step + k greedy bf16 decode "
        f"steps on {COLLOC_SLOTS} dense rows of {COLLOC_MAX_SEQ}, the chain a CUDA graph a "
        f"k): train result bit-equal across k = {list(COLLOC_KS)} and to the step alone, "
        "tokens equal to the eager chain's; ms fused / step alone + k eager decode steps "
        "alone: " + "; ".join(
            f"k={k} {rows[k] * 1e3:.1f} / {alone_s * 1e3:.1f} + {chains[k][1] * 1e3:.1f} = "
            f"{(alone_s + chains[k][1]) * 1e3:.1f}" for k in COLLOC_KS)
        + f"; peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; launches "
        f"{json.dumps(got)}")
    pool = max(fused[k].graphs.pool_bytes() for k in captures)
    for r in chain_rows:
        log(f"collocated step graph {r['program']}: bit-equal to its eager call; eager "
            f"{r['eager_ms']:.3f} ms, replay {r['replay_ms']:.3f} ms "
            f"({r['eager_ms'] / r['replay_ms']:.1f}x), {r['launches']} launches a replay "
            f"(counted), kernels {json.dumps(r['kernels'])}, capture {r['capture_s']:.2f}s")
    log(f"collocated step: captures by k {json.dumps(captures)}; pools "
        + ", ".join(f"k={k} {fused[k].graphs.pool_bytes() / 1e6:.1f} MB" for k in captures)
        + f" (largest {pool / 1e6:.1f} MB)")
    del base, ref, infer, cache0, graph
    _end_phase("collocated step")
    log(f"collocated step: {time.monotonic() - t_phase:.1f}s")
    return {n: c["cuda"] for n, c in counts.items()}


def phase_scale_out():
    """Phases 30 and 31, then 32, 33 and 34, in one process group: one rank
    over NCCL, joined through a ``FileStore`` in a temporary directory.
    Returns ({run label: launch counts}, phases 32's and 34's kernel
    rows)."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_dev_mesh

    store = tempfile.mkdtemp(prefix="scale_out_")
    dist.init_process_group("nccl", init_method=f"file://{store}/store", rank=0, world_size=1)
    try:
        mesh = make_dev_mesh(device="cuda")
        scale, trainer = phase_sharded_step(mesh)
        colloc = phase_collocated_step(trainer)
        del trainer
        _end_phase("scale out + collocated step")
        model_axis_rows = phase_model_axis_kernels()
        serve_steps = phase_serve_steps(mesh)
        ssm_runs, ssm_rows = phase_ssm_model_axis()
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    return ({"scale_out": scale, "collocated_step": colloc, **serve_steps, **ssm_runs},
            model_axis_rows + ssm_rows)


# ---------------------------------------------------------------------------
# 32. the model axis' kernels at each rank's shapes, 33. the serve steps on a
# one-rank mesh
# ---------------------------------------------------------------------------

#: phase 32: qwen3-1.7b's decode attention (8 rows, 16 q / 8 KV heads of 128)
#: over a sequence-split dense cache of S rows in m blocks; each row's length
#: leaves whole blocks empty (1 key: every block but the first)
MA_SPLITS = (2, 4, 16)
MA_LENGTHS = {512: [1, 37, 100, 200, 256, 300, 511, 512],
              4096: [1, 300, 1000, 2048, 2100, 3000, 4000, 4096]}
#: fp32 partial + merge against #3 over the whole cache (merges in another
#: order); the partials' (m, l) and acc against the plain partial, relative
PARTIAL_FP32_ATOL = 1e-5
PARTIAL_RTOL = 1e-4
#: the headline row: qwen3-1.7b at model 16 over phase 33's 512-row cache
MA_ROW_S, MA_ROW_M = 512, 16
#: the port's sequence-parallel serve steps on a 16-rank stand-in mesh:
#: qwen3-1.7b at full width and depth in fp32 (its 8 KV heads do not divide
#: 16, so each rank holds 32 of the 512 cache rows of every KV head), 8 rows
#: of a 124-token prompt, so that the 8 decode steps write rank 3's block
#: and then rank 4's
SP_ARCH, SP_RANKS, SP_PROMPT, SP_DECODES = "qwen3-1.7b", 16, 124, 8
#: the split run's prefill and decode logits and its gathered cache against
#: the unsplit run's, relative to their max (fp32; the model-axis sums and
#: the partials' merge add in another order, over 28 layers)
SP_RTOL = 1e-4
#: how long a rank of the stand-in mesh waits for the others at a collective
SP_WAIT_S = 300.0
#: flash at olmo-1b's local head counts (16 heads over model 2 and 16)
FLASH_LOCAL_CASES = ((TRAIN_B, 8, TRAIN_S, TRAIN_S, True, HD),
                     (TRAIN_B, 1, TRAIN_S, TRAIN_S, True, HD))
#: phase 33: 8 rows of a 128-token prompt in a 512-row cache, 32 decode steps
SERVE_STEP_ROWS, SERVE_STEP_PROMPT, SERVE_STEP_SEQ, SERVE_STEP_DECODES = 8, 128, 512, 32
#: phase 33's 8-bit cache: the first decode step's logits over it against
#: the same step's over the bf16 cache, as a cosine (the reference's
#: criterion, ``tests/test_perf_variants.py``); qwen3-1.7b's long cache (8
#: rows of 4,096) and its decode steps
FP8_MIN_COSINE = 0.98
#: bf16 compute: a step's token may differ from the plain version's only at
#: a tie in bf16, the plain logits of the two tokens at most this many bf16
#: steps (2^-7 relative) apart (#3 and its plain version round the
#: attention output to bf16 in other places); fp32 compute: equal
FP8_TIE_ULPS = 2
FP8_LONG_SEQ, FP8_LONG_DECODES = 4096, 8
#: the sequence-parallel decode over an 8-bit cache: qwen3-1.7b at full width
#: cut to 2 layers on the (1, 16) stand-in mesh; the split run's logits
#: against the unsplit run's within this share of their max (a code next to
#: the unsplit run's, where the two runs' fp32 K / V fall either side of a
#: rounding midpoint, moves an entry by up to 1/8 of its value)
FP8_SP_LAYERS, FP8_SP_RTOL = 2, 1e-2
#: the FSDP serve steps: qwen3-1.7b at full width and depth (fp32) on a
#: (data, model) = (4, 1) stand-in mesh, 2 of the 8 rows a rank
FSDP_SERVE_MESH = (4, 1)


def _partial_blocks(q, k, v, lengths, m, partial):
    """``partial`` over each of the m contiguous sequence blocks of k / v
    (each block contiguous, as a rank holds it, copied as its bytes: an
    8-bit cache too), with each row's block length ``clamp(length - r *
    S/m, 0, S/m)``: the blocks' (acc, ml) stacked ``[B, m, H, hd]`` /
    ``[B, m, H, 2]``."""
    import torch

    def block(t, r):
        return t.view(torch.uint8)[:, r * blk:(r + 1) * blk].contiguous().view(t.dtype)

    blk = k.shape[1] // m
    parts = [partial(q, block(k, r), block(v, r),
                     (lengths - r * blk).clamp(0, blk).to(torch.int32)) for r in range(m)]
    return (torch.stack([a for a, _ in parts], 1).contiguous(),
            torch.stack([b for _, b in parts], 1).contiguous())


def _seq_parallel(m, plain=False):
    """(q, k, v, lengths) -> the attention output through m blocks' partials
    and their merge: the kernels', or (``plain``) their plain versions'."""
    from repro_torch.kernels import decode_attention as dd

    partial = dd.decode_partial_core if plain else dd.decode_attention_partial
    merge = dd.combine_partials_core if plain else dd.combine_splits

    def run(q, k, v, lengths):
        acc, ml = _partial_blocks(q, k, v, lengths, m, partial)
        return merge(acc, ml, q.dtype)
    return run


class _Turns:
    """The ranks of a stand-in mesh, run as threads of this process one at
    a time: a rank holds the turn until it reaches a collective, where it
    leaves a copy of its block, hands the turn on and waits until every
    rank has left its block and read the others'.  The activation-sharding
    and FSDP gather contexts are one per process, so each rank's are put
    back when its turn comes again."""

    def __init__(self, n: int):
        import threading

        self.n = n
        self.turn = threading.Lock()
        self.barrier = threading.Barrier(n, timeout=SP_WAIT_S)
        self.slots = [None] * n

    def wait(self, between):
        """Hand the turn on, and ``between()`` once every rank is here
        (while no rank runs: no launch, no collective)."""
        from repro_torch.models import act_sharding as AS
        from repro_torch.models import fsdp as FS

        ctx, gather = AS._ACTIVE, FS._ACTIVE
        self.turn.release()
        try:
            self.barrier.wait()
            out = between()
            self.barrier.wait()
        finally:
            self.turn.acquire()
            AS._ACTIVE, FS._ACTIVE = ctx, gather
        return out

    def exchange(self, rank: int, t):
        """Every rank's ``t`` (copies: an owner may write its own in place
        before the others' reads run), in rank order."""
        self.slots[rank] = t.clone()
        return self.wait(lambda: list(self.slots))

    def run(self, fn, meshes) -> list:
        """``fn(rank, mesh)`` on every rank, each a thread; their results
        in rank order.  A rank that raises breaks the others' waits."""
        import threading

        from repro_torch.models import act_sharding as AS
        from repro_torch.models import fsdp as FS

        results, errors = [None] * self.n, [None] * self.n

        def body(rank):
            self.turn.acquire()
            try:
                AS._ACTIVE = FS._ACTIVE = None
                results[rank] = fn(rank, meshes[rank])
            except BaseException as e:  # noqa: BLE001 -- re-raised below
                errors[rank] = e
                self.barrier.abort()
            finally:
                self.turn.release()

        threads = [threading.Thread(target=body, args=(r,), daemon=True)
                   for r in range(self.n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(SP_WAIT_S)
        AS._ACTIVE = FS._ACTIVE = None
        if any(t.is_alive() for t in threads):
            raise AssertionError(f"stand-in mesh: ranks still running after {SP_WAIT_S} s")
        raised = [e for e in errors if e is not None]
        if raised:
            raise next((e for e in raised if not isinstance(e, threading.BrokenBarrierError)),
                       raised[0])
        return results


class _ThreadMesh:
    """One rank's view of a mesh whose ranks are ``_Turns`` threads: the
    ``launch.mesh.Mesh`` interface the model code and the serve steps read,
    each collective served from the blocks every rank left (summed or
    concatenated in rank order, so every rank gets the same result)."""

    def __init__(self, turns: _Turns, shape: tuple, axis_names: tuple, rank: int, device):
        import collections

        import numpy as np

        self.turns, self.rank, self.device = turns, rank, device
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, shape))
        self._coords = [dict(zip(self.axis_names, map(int, np.unravel_index(q, shape))))
                        for q in range(turns.n)]
        self.coordinate = self._coords[rank]
        self.collectives = collections.Counter()

    def axes(self, entry):
        from repro_torch.launch.mesh import Mesh

        return Mesh.axes(self, entry)

    def size(self, axes):
        from repro_torch.launch.mesh import Mesh

        return Mesh.size(self, axes)

    def index(self, axes):
        from repro_torch.launch.mesh import Mesh

        return Mesh.index(self, axes)

    def _group(self, axes, blocks):
        """The blocks of the ranks that differ from this one only on
        ``axes``, in their row-major order there."""
        rest = [a for a in self.axis_names if a not in axes]
        members = [q for q, c in enumerate(self._coords)
                   if all(c[a] == self.coordinate[a] for a in rest)]
        return [blocks[q] for q in sorted(
            members, key=lambda q: [self._coords[q][a] for a in axes])]

    def all_reduce(self, t, axes, op="sum"):
        import torch

        blocks = self._group(axes, self.turns.exchange(self.rank, t))
        out = blocks[0].clone()
        for b in blocks[1:]:
            out = out + b if op == "sum" else torch.maximum(out, b)
        t.copy_(out)
        self.collectives["all_reduce"] += 1
        return t

    def all_gather(self, t, axes, dim):
        import torch

        blocks = self._group(axes, self.turns.exchange(self.rank, t))
        self.collectives["all_gather"] += 1
        return torch.cat([b.movedim(dim, 0) for b in blocks]).movedim(0, dim)


#: an 8-bit cache's codes against another run's: the share of entries whose
#: code differs (each only next to the other's) may be at most this
FP8_STRADDLE_SHARE = 1e-3


def _fp8_code_share(a, b) -> float:
    """The share of two 8-bit caches' entries whose codes differ; raises
    when a code is not next to the other's on the number line (+0 and -0
    meet at zero) or the share passes ``FP8_STRADDLE_SHARE``."""
    import torch

    def key(t):
        c = t.view(torch.uint8).to(torch.int32)
        return torch.where(c >= 128, -(c - 128), c)

    diff = (key(a) - key(b)).abs()
    share = (diff > 0).float().mean().item()
    if diff.max().item() > 1 or share > FP8_STRADDLE_SHARE:
        raise AssertionError(f"8-bit cache codes: {share:.2e} of the entries differ, up to "
                             f"{diff.max().item()} codes apart (at most "
                             f"{FP8_STRADDLE_SHARE:g}, 1 apart)")
    return share


def _kv_seq_entry(specs):
    """The dense cache's sequence entry of a cache spec tree (None: Mamba1
    holds no K/V)."""
    layers = specs["layers"]
    kv = layers.get("k", layers.get("shared_k"))
    return kv[2] if kv is not None else None


def _stand_in_serve(cfg, ranks, rows, seq, prompt, decodes, seed, device="cuda", *,
                    mesh_shape=None, fsdp=None, cache_dtype=None, rtol=SP_RTOL):
    """The port's serve steps driven through its entry points:
    ``make_prefill_step`` and ``decodes`` ``make_serve_step`` steps of
    ``cfg`` in fp32 on a ``(data, model)`` stand-in mesh (``_Turns``;
    ``mesh_shape``, by default ``(1, ranks)``), each rank on its blocks of
    the weights (its FSDP shards under ``fsdp``) and of the batch, the
    cache in ``cache_dtype`` (default fp32).  The tokens equal, and the
    prefill logits, the logits of one more decode step and every leaf of the
    gathered cache within ``rtol`` of their max, the unsplit ``T.prefill`` +
    ``T.decode_step`` on the same weights (an 8-bit cache leaf: its codes
    equal but for codes next to them, at most ``FP8_STRADDLE_SHARE`` of the
    entries: a value the two runs compute a rounding apart, either side of a
    midpoint).  Returns the launch counts of the steps (read from 0 just
    before the ranks start until every rank has taken its last step) and a
    summary (each rank's cache leaf shapes and sequence entry among it, its
    most FSDP-gathered bytes alive at once, the device's peak during the
    run above the memory before it)."""
    import torch

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.models.act_sharding import activation_sharding
    from repro_torch.runtime import make_prefill_step, make_serve_step
    from repro_torch.runtime import sharding as S
    from repro_torch.tree import tree_leaves, tree_map, tree_map_with_path

    from repro_torch.runtime import step as step_mod

    f32 = torch.float32
    gen = torch.Generator(device=device).manual_seed(seed)
    params = T.init_params(cfg, gen, dtype=f32)
    prompts = torch.randint(0, cfg.vocab_size, (rows, prompt), generator=gen, device=device,
                            dtype=torch.int32)
    with torch.no_grad():
        ref_logits, ref_cache = T.prefill(cfg, params, prompts, seq, compute_dtype=f32,
                                          cache_dtype=cache_dtype or f32)
        tok = torch.argmax(ref_logits, -1).to(torch.int32)
        ref_toks, ref_step_logits = [], []
        for _ in range(decodes + 1):
            lg, ref_cache = T.decode_step(cfg, params, tok, ref_cache, compute_dtype=f32)
            ref_step_logits.append(lg)
            ref_toks.append(tok := torch.argmax(lg, -1).to(torch.int32))
        # the cache as the split run leaves it: the token of the extra step
        # is written there too, at the same index
    shape = ShapeConfig("stand_in", seq, rows, "decode")
    mesh_shape = mesh_shape or (1, ranks)
    turns = _Turns(ranks)
    meshes = [_ThreadMesh(turns, mesh_shape, ("data", "model"), r, torch.device(device))
              for r in range(ranks)]
    kw = dict(compute_dtype=f32, fsdp=fsdp, cache_dtype=cache_dtype)

    def rank_run(rank, mesh):
        pre = make_prefill_step(cfg, mesh, shape, **kw)
        dec = make_serve_step(cfg, mesh, shape, **kw)
        local = pre.shard_params(params)
        logits, cache = pre.step(local, pre.shard_inputs(prompts))
        full = pre.gather_output(logits)
        tok = S.shard_tensor(torch.argmax(full, -1).to(torch.int32), dec.input_specs, mesh)
        toks = []
        for _ in range(decodes):
            tok, cache = dec.step(local, tok, cache)
            toks.append(dec.gather_output(tok))
        counts, colls = turns.wait(lambda: (ops.launch_counts(), dict(mesh.collectives)))
        # one more decode step's logits, under the step's own contexts (not
        # counted: the counts are read), on this rank's rows
        seq_entry = _kv_seq_entry(dec.cache_specs)
        specs = S.activation_specs(cfg, mesh, batch_sharded=dec.batch_sharded)
        index = cache["index"]
        if index.ndim == 1 and dec.batch_sharded:
            index = S.shard_tensor(index, dec.input_specs, mesh)
        with torch.no_grad(), activation_sharding(mesh, specs, cache_seq=seq_entry), \
                step_mod._serve_gather(dec, local):
            lg, cache = T.decode_step(cfg, local, tok, dict(cache, index=index),
                                      compute_dtype=f32)
        rows_entry = dec.input_specs[0] if len(dec.input_specs) else None
        lg = S.gather_tensor(lg, S.P(rows_entry, S.ShardingPlan(cfg, mesh).vocab()), mesh)
        return {"prefill": full, "tokens": toks, "logits": lg, "counts": counts,
                "collectives": colls, "seq_entry": seq_entry,
                "local": tree_map(lambda t: tuple(t.shape), cache["layers"]),
                "cache": dec.gather_cache(cache),
                "gathered": max(pre.max_live_gathered_bytes, dec.max_live_gathered_bytes),
                "shard_bytes": sum(t.numel() * t.element_size() for t in tree_leaves(local))}

    ops.reset_launch_counts()
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    results = turns.run(rank_run, meshes)
    secs = time.monotonic() - t0
    peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9 if on_card else None

    def rel(a, b):
        if a.element_size() == 1:  # an 8-bit cache leaf: its codes
            errs["cache_code_share"] = max(errs.get("cache_code_share", 0.0),
                                           _fp8_code_share(a, b))
            return 0.0
        return ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()

    errs = {"prefill": 0.0, "logits": 0.0, "cache": 0.0}
    for rank, res in enumerate(results):
        if not all(torch.equal(a, b) for a, b in zip(res["tokens"], ref_toks)):
            raise AssertionError(f"{cfg.name} stand-in serve rank {rank}: tokens differ from "
                                 "the unsplit run's")
        errs["prefill"] = max(errs["prefill"], rel(res["prefill"], ref_logits))
        errs["logits"] = max(errs["logits"], rel(res["logits"], ref_step_logits[decodes]))
        leaves = []
        tree_map_with_path(lambda path, t: leaves.append((path, t)), ref_cache["layers"])
        got = res["cache"]["layers"]
        for path, want in leaves:
            have = got
            for key in path.split("/"):
                have = have[key]
            errs["cache"] = max(errs["cache"], rel(have, want))
    if max(v for k, v in errs.items() if k != "cache_code_share") > rtol:
        raise AssertionError(f"{cfg.name} stand-in serve: split run against the unsplit {errs} "
                             f"(tolerance {rtol:g} of the max)")
    counts, colls = results[0]["counts"], results[0]["collectives"]
    summary = {"arch": cfg.name, "ranks": ranks, "mesh": mesh_shape, "layers": cfg.num_layers,
               "rows": rows, "seq": seq, "prompt": prompt, "decodes": decodes,
               "seconds": secs, "errors": errs, "collectives_rank0": colls,
               "seq_entries": [res["seq_entry"] for res in results],
               "local": [res["local"] for res in results],
               "gathered": [res["gathered"] for res in results],
               "shard_bytes": [res["shard_bytes"] for res in results],
               "peak_above_base_gb": peak_gb}
    del results, params, ref_cache
    return counts, summary


def _seq_parallel_serve(cfg):
    """The port's sequence-parallel decode (``_stand_in_serve`` of ``cfg``
    on ``SP_RANKS`` ranks, whose cache splits its sequence over
    ``model``)."""
    counts, sp = _stand_in_serve(cfg, SP_RANKS, SERVE_STEP_ROWS, SERVE_STEP_SEQ, SP_PROMPT,
                                 SP_DECODES, seed=32)
    for rank, (entry, local) in enumerate(zip(sp["seq_entries"], sp["local"])):
        if entry != "model" or local["k"][2] != SERVE_STEP_SEQ // SP_RANKS:
            raise AssertionError(f"seq parallel rank {rank}: the cache is not sequence-split "
                                 f"({entry}, {local['k']})")
    return counts, sp


def phase_model_axis_kernels():
    """Phase 32: #3's partial form over m in ``MA_SPLITS`` contiguous
    sequence blocks of qwen3-1.7b's decode cache (B = 8, H = 16, kvH = 8,
    hd 128; S = 512 and 4,096; bf16 and fp32), merged by
    ``paged::combine_splits``: against #3 over the whole cache (bf16
    ``BF16_ATOL``, fp32 ``PARTIAL_FP32_ATOL``) and against the plain partial
    and merge (the merged output at the table tolerances; every block's l,
    and m / acc where l > 0, within ``PARTIAL_RTOL`` of their max; a block
    no key reached stores l = 0 exactly), a NaN in one slot; then one
    block's partial and the merge timed beside #3 over the whole cache;
    flash #5 forward and backward at olmo-1b's local head counts (8 and 1)
    against its plain version; and the port's sequence-parallel serve steps
    on a 16-rank stand-in mesh (``_seq_parallel_serve``), whose launches the
    two kernel rows report.  Returns the two kernel rows."""
    import torch

    from repro_torch import configs
    from repro_torch.kernels import decode_attention as dd
    from repro_torch.kernels import flash_attention as fa

    t_phase = time.monotonic()
    _fresh_phase()
    worst = {"bfloat16": 0.0, "float32": 0.0}
    for s_len, lens in MA_LENGTHS.items():
        lengths = _i32(lens)
        for dtype in (torch.bfloat16, torch.float32):
            g, k, v = _dense_inputs(dtype, seed=32, s=s_len)
            q = torch.randn((B, H, HD), generator=g, device="cuda").to(dtype)
            whole = dd.decode_attention(q, k, v, lengths)
            f32 = [t.float() for t in (q, k, v)]
            for m in MA_SPLITS:
                acc, ml = _partial_blocks(q, k, v, lengths, m, dd.decode_attention_partial)
                out = dd.combine_splits(acc, ml, dtype)
                pacc, pml = _partial_blocks(*f32, lengths, m, dd.decode_partial_core)
                plain = dd.combine_partials_core(pacc, pml, torch.float32)
                torch.cuda.synchronize()
                bf16 = dtype == torch.bfloat16
                tol = BF16_ATOL if bf16 else PARTIAL_FP32_ATOL
                err_whole = (out.float() - whole.float()).abs().max().item()
                err_plain = (out.float() - plain).abs().max().item()
                seen = pml[..., 1] > 0
                err_l = ((ml[..., 1] - pml[..., 1]).abs().max() / pml[..., 1].abs().max()).item()
                err_m = (ml[..., 0] - pml[..., 0])[seen].abs().max().item()
                err_acc = ((acc - pacc).abs().max() / pacc.abs().max()).item()
                empty = ml[..., 1][~seen]
                label = f"decode_attention_partial S={s_len} m={m} {dtype}"
                log(f"kernel {label}: merged vs #3 whole {err_whole:.3e} (tol {tol:g}), vs "
                    f"plain {err_plain:.3e}; partials l {err_l:.3e} m {err_m:.3e} acc "
                    f"{err_acc:.3e} (tol {PARTIAL_RTOL:g}); {int((~seen).sum())} empty "
                    f"(block, row, head)s")
                if not (torch.isfinite(out).all() and err_whole <= tol
                        and err_plain <= (BF16_ATOL if bf16 else FP32_ATOL)
                        and max(err_l, err_m, err_acc) <= PARTIAL_RTOL
                        and (empty == 0).all() and (~seen).any()):
                    raise AssertionError(f"{label}: out of tolerance or an empty block's l "
                                         "not zero")
                worst[str(dtype).split(".")[-1]] = max(worst[str(dtype).split(".")[-1]],
                                                        err_whole, err_plain)
    for m in (2, MA_ROW_M):
        def make(dtype, m=m):
            g, k, v = _dense_inputs(dtype, seed=33, s=MA_ROW_S)
            q = torch.randn((B, H, HD), generator=g, device="cuda").to(dtype)
            return q, k, v, _i32(MA_LENGTHS[MA_ROW_S])
        _check_nan_slot(f"decode_attention_partial + combine_splits (m={m})",
                        _seq_parallel(m), _seq_parallel(m, plain=True), make,
                        _poison_dense(2, 50), 2)

    # timed at the headline shape: one block (the first: every row's keys
    # start there) and the merge of the 16 blocks' partials
    lengths = _i32(MA_LENGTHS[MA_ROW_S])
    g, k, v = _dense_inputs(torch.bfloat16, seed=32, s=MA_ROW_S)
    q = torch.randn((B, H, HD), generator=g, device="cuda").to(torch.bfloat16)
    blk = MA_ROW_S // MA_ROW_M
    kb, vb = k[:, :blk].contiguous(), v[:, :blk].contiguous()
    lb = lengths.clamp(0, blk).to(torch.int32)
    acc, ml = _partial_blocks(q, k, v, lengths, MA_ROW_M, dd.decode_attention_partial)
    pacc, pml = acc.clone(), ml.clone()
    part_ms = _time_ms(lambda: dd.decode_attention_partial(q, kb, vb, lb))
    merge_ms = _time_ms(lambda: dd.combine_splits(acc, ml, torch.bfloat16))
    part_plain = _time_ms(lambda: dd.decode_partial_core(q, kb, vb, lb))
    merge_plain = _time_ms(lambda: dd.combine_partials_core(pacc, pml, torch.bfloat16))
    whole_ms = _time_ms(lambda: dd.decode_attention(q, k, v, lengths))
    # the library call with the same state: PyTorch's memory-efficient SDPA
    # over the block (KV heads expanded to the q heads, the rows' lengths as
    # a -inf bias) returns the normalised output and its logsumexp, which are
    # acc / l and m + ln l
    group = H // KVH
    lq = q[:, :, None]
    lk, lv = (t.permute(0, 2, 1, 3).repeat_interleave(group, 1).contiguous() for t in (kb, vb))
    keep = torch.arange(blk, device="cuda")[None, :] < lb[:, None]
    bias = torch.zeros((B, H, 1, blk), dtype=torch.bfloat16, device="cuda").masked_fill(
        ~keep[:, None, None], float("-inf"))
    sdpa = torch.ops.aten._scaled_dot_product_efficient_attention

    def library():
        return sdpa(lq, lk, lv, bias, True)

    lib_out, lib_lse = library()[:2]
    b_acc, b_ml = dd.decode_attention_partial(q, kb, vb, lb)
    lib_err = max((lib_out[:, :, 0].float() - b_acc / b_ml[..., 1:]).abs().max().item(),
                  (lib_lse[:, :, 0] - b_ml[..., 0] - b_ml[..., 1].log()).abs().max().item())
    if not lib_err <= BF16_ATOL:
        raise AssertionError(f"decode_attention_partial: the library call's state differs by "
                             f"{lib_err:.3e} (tolerance {BF16_ATOL:g})")
    lib_ms = _time_ms(library)
    p_bound, p_by = _cost_bound("decode_partial", q, kb, vb, lb)
    m_bound, m_by = _cost_bound("combine", acc, ml, torch.bfloat16)
    log(f"kernel decode_attention_partial ({_card()}; S={MA_ROW_S} in {MA_ROW_M} blocks of "
        f"{blk}, bf16): one block's partial {part_ms:.4f} ms (plain {part_plain:.4f}, bound "
        f"{p_bound:.4f} by {p_by}) + the merge {merge_ms:.4f} ms (plain {merge_plain:.4f}, "
        f"bound {m_bound:.4f} by {m_by}) = {part_ms + merge_ms:.4f} ms, beside #3 over the "
        f"whole cache {whole_ms:.4f} ms; the library call (memory-efficient SDPA with its "
        f"logsumexp over the block) {lib_ms:.4f} ms, its state within {lib_err:.3e} of the "
        f"partial's")

    # flash at olmo-1b's local head counts
    flash = _check_flash(FLASH_LOCAL_CASES)
    for case in FLASH_LOCAL_CASES:
        fq, fk, fv, _ = _flash_inputs(torch.bfloat16, *case[:4], case[5])
        f_ms = _time_ms(lambda: fa.flash_attention_fwd(fq, fk, fv, causal=True))
        log(f"kernel flash_attention at olmo-1b's local heads {case}: forward {f_ms:.4f} ms "
            f"(bf16); worst errors {flash}")

    # the port's own sequence-parallel decode: the serve steps of qwen3-1.7b
    # on a 16-rank stand-in mesh, whose launches the two rows report
    counts, sp = _seq_parallel_serve(configs.get_config(SP_ARCH))
    _require_launches("seq parallel serve", counts,
                      ("decode_attention_partial", "combine_splits", "flash_attention_fwd"))
    launches = {n: counts[n]["cuda"] for n in ("decode_attention_partial", "combine_splits",
                                               "flash_attention_fwd")}
    per_step = SP_RANKS * sp["layers"] * SP_DECODES
    want = {"decode_attention_partial": per_step, "combine_splits": per_step,
            "flash_attention_fwd": SP_RANKS * sp["layers"]}
    if launches != want:
        raise AssertionError(f"seq parallel serve: launches {launches}, expected {want}")
    log(f"seq parallel serve ({_card()}; {SP_ARCH} full width and depth, fp32, "
        f"make_prefill_step + {SP_DECODES} make_serve_step steps on a (1, {SP_RANKS}) stand-in "
        f"mesh of threads, {sp['rows']} rows of {SP_PROMPT}-token prompts in "
        f"{sp['seq']} rows, each rank {sp['seq'] // SP_RANKS} of them): tokens equal to the "
        f"unsplit T.prefill + T.decode_step, errors relative to the max {sp['errors']} "
        f"(tolerance {SP_RTOL:g}); {sp['seconds']:.1f} s for all ranks in turn; rank 0's "
        f"collectives {json.dumps(sp['collectives_rank0'])}; launches {json.dumps(launches)}")
    rows = [
        {"name": "decode_attention_partial", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
         "replaces": "src/repro/kernels/decode_attention.py:92",
         "launches": launches["decode_attention_partial"], "max_abs_err": worst["bfloat16"],
         "max_abs_err_fp32": worst["float32"], "ms": part_ms, "plain_ms": part_plain,
         "bound_ms": p_bound, "bound_by": p_by, "library_ms": lib_ms},
        {"name": "combine_splits", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/paged_attention.cuh",
         "replaces": "src/repro/kernels/decode_attention.py:92",
         "launches": launches["combine_splits"], "max_abs_err": worst["bfloat16"],
         "max_abs_err_fp32": worst["float32"], "ms": merge_ms, "plain_ms": merge_plain,
         "bound_ms": m_bound, "bound_by": m_by, "library_ms": None},
    ]
    del k, v, kb, vb, acc, ml, pacc, pml
    _end_phase("model axis kernels")
    log(f"model axis kernels: {time.monotonic() - t_phase:.1f}s")
    return rows


def phase_serve_steps(mesh):
    """Phase 33: ``make_prefill_step`` and then ``SERVE_STEP_DECODES``
    ``make_serve_step`` steps on ``mesh`` (one NCCL rank: every collective
    an identity, none issued), at olmo-1b's and qwen3-1.7b's full width and
    depth in bf16, on ``SERVE_STEP_ROWS`` rows of a ``SERVE_STEP_PROMPT``-
    token prompt in a ``SERVE_STEP_SEQ``-row cache: the tokens bit-equal to
    ``T.prefill`` plus eager ``T.decode_step`` on the same weights.  Prints
    each step's time beside the eager decode step's, the peak memory and
    the collectives a step.  Then the same steps over an 8-bit cache
    (``_fp8_serve_steps``), the sequence-parallel decode over one
    (``_fp8_seq_parallel_serve``) and the FSDP serve steps
    (``_fsdp_serve_steps``).  Returns ``{"serve_steps": the bf16 steps'
    launch counts, "serve_steps_fp8": the 8-bit runs'}``."""
    import torch

    from repro_torch import configs
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.runtime import make_prefill_step, make_serve_step

    t_phase = time.monotonic()
    total, fp8 = {}, {}
    for arch in ("olmo-1b", "qwen3-1.7b"):
        _fresh_phase()
        cfg = configs.get_config(arch)
        gen = torch.Generator(device="cuda").manual_seed(33)
        params = T.init_params(cfg, gen, dtype=torch.bfloat16)
        shape = ShapeConfig("serve_steps", SERVE_STEP_SEQ, SERVE_STEP_ROWS, "decode")
        pre, dec = make_prefill_step(cfg, mesh, shape), make_serve_step(cfg, mesh, shape)
        local = pre.shard_params(params)
        prompts = torch.randint(0, cfg.vocab_size, (SERVE_STEP_ROWS, SERVE_STEP_PROMPT),
                                generator=gen, device="cuda", dtype=torch.int32)
        inputs = pre.shard_inputs(prompts)
        ops.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        before = dict(mesh.collectives)
        (logits, cache), pre_s = _timed(pre.step, local, inputs)
        colls = {k: v - before.get(k, 0) for k, v in mesh.collectives.items()
                 if v - before.get(k, 0)}
        tok = torch.argmax(pre.gather_output(logits), -1).to(torch.int32)
        toks, step_s = [], []
        before = dict(mesh.collectives)
        for _ in range(SERVE_STEP_DECODES):
            (tok, cache), dt = _timed(dec.step, local, tok, cache)
            toks.append(tok)
            step_s.append(dt)
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated() / 1e9
        colls.update({k: v - before.get(k, 0) for k, v in mesh.collectives.items()
                      if v - before.get(k, 0)})
        with torch.no_grad():
            (ref_logits, ref_cache), eager_pre = _timed(
                lambda: T.prefill(cfg, params, prompts, SERVE_STEP_SEQ))
            ref = torch.argmax(ref_logits, -1).to(torch.int32)
            ref_toks, eager_s = [], []
            for _ in range(SERVE_STEP_DECODES):
                (lg, ref_cache), dt = _timed(T.decode_step, cfg, params, ref, ref_cache)
                ref = torch.argmax(lg, -1).to(torch.int32)
                ref_toks.append(ref)
                eager_s.append(dt)
        if not torch.equal(logits, ref_logits):
            raise AssertionError(f"serve steps {arch}: prefill logits differ from T.prefill's")
        if not all(torch.equal(a, b) for a, b in zip(toks, ref_toks)):
            raise AssertionError(f"serve steps {arch}: tokens differ from the eager chain's")
        if colls:
            raise AssertionError(f"serve steps {arch}: collectives {colls} at one rank")
        _require_launches(f"serve steps {arch}", counts,
                          ("flash_attention_fwd", "decode_attention"))
        want = {"flash_attention_fwd": cfg.num_layers,
                "decode_attention": cfg.num_layers * SERVE_STEP_DECODES}
        got = {n: counts[n]["cuda"] for n in want}
        if got != want:
            raise AssertionError(f"serve steps {arch}: launches {got}, expected {want}")
        med = lambda xs: sorted(xs)[len(xs) // 2] * 1e3
        jit_counts = _jitted_serve_steps(f"{arch} bf16", pre, dec, local, inputs, logits, toks,
                                         want, med(step_s))
        for n in counts:
            total[n] = total.get(n, 0) + counts[n]["cuda"] + jit_counts[n]["cuda"]
        log(f"serve steps ({_card()}; {arch} full depth, bf16, {SERVE_STEP_ROWS} rows x "
            f"{SERVE_STEP_PROMPT}-token prompts in {SERVE_STEP_SEQ} rows, mesh {mesh.shape} "
            f"over NCCL): tokens of prefill + {SERVE_STEP_DECODES} steps bit-equal to "
            f"T.prefill + eager T.decode_step; prefill {pre_s * 1e3:.1f} ms (eager "
            f"{eager_pre * 1e3:.1f}); decode step ms median {med(step_s):.2f}, min "
            f"{min(step_s) * 1e3:.2f}, max {max(step_s) * 1e3:.2f} (eager median "
            f"{med(eager_s):.2f}, min {min(eager_s) * 1e3:.2f}); peak device memory "
            f"{peak:.2f} GB; collectives a step {json.dumps(colls)}; launches "
            f"{json.dumps(got)}")
        del cache, ref_cache, logits, ref_logits
        fp8 = _fp8_serve_steps(cfg, mesh, params, local, prompts, med(step_s), peak, fp8)
        del params, local
    fp8 = _fp8_seq_parallel_serve(fp8)
    _fsdp_serve_steps()
    _end_phase("serve steps")
    log(f"serve steps: {time.monotonic() - t_phase:.1f}s")
    return {"serve_steps": total, "serve_steps_fp8": fp8}


def _jitted_serve_steps(label, pre, dec, local, inputs, want_logits, want_toks, want,
                        eager_ms):
    """The serve steps' ``jitted()`` on the one-rank NCCL mesh over
    ``F1_CYCLES`` prefill -> ``SERVE_STEP_DECODES``-step decode cycles, all
    replayed as CUDA graphs, one capture each: each prefill returns a new
    cache, which the decode graph copies into its own buffers at the
    cycle's first step and then writes in place.  Every cycle's prefill
    logits bit-equal to ``want_logits`` (the eager step's) and every step's
    tokens to ``want_toks``'s; the kernels of ``want`` launched as often as
    by the eager steps in every cycle; one live graph each; the device
    memory allocated after each cycle within ``FLAT_BYTES`` of the
    first's.  Each graph is then held to its eager call
    (``_check_program``: eager and replay ms, launches a replay, capture
    s).  Returns the first cycle's launch counts."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.tree import tree_leaves

    pj, dj = pre.jitted(), dec.jitted()
    cycles, first = [], None
    for cycle in range(F1_CYCLES):
        ops.reset_launch_counts()
        logits, cache = pj(local, inputs)
        tok = torch.argmax(pre.gather_output(logits), -1).to(torch.int32)
        step_s = []
        for want_tok in want_toks:
            (tok, cache), dt = _timed(dj, local, tok, cache)
            step_s.append(dt)
            if not torch.equal(tok, want_tok):
                raise AssertionError(f"serve steps {label}: jitted() tokens differ from the "
                                     f"eager step's at cycle {cycle}, step {len(step_s)}")
        counts = ops.launch_counts()
        got = {n: counts[n]["cuda"] for n in want}
        if got != want:
            raise AssertionError(f"serve steps {label}: jitted() launches {got} in cycle "
                                 f"{cycle}, expected {want}")
        if not torch.equal(logits, want_logits):
            raise AssertionError(f"serve steps {label}: jitted() prefill logits differ from "
                                 f"the eager step's in cycle {cycle}")
        if first is None:
            first, steady = counts, sorted(step_s[1:])[len(step_s[1:]) // 2] * 1e3
        del logits, tok
        gc.collect()
        torch.cuda.synchronize()
        cycles.append((torch.cuda.memory_allocated(), (pj.graphs.captures, dj.graphs.captures),
                       (len(pj.graphs.graphs), len(dj.graphs.graphs))))
    if any(c[1:] != ((1, 1), (1, 1)) for c in cycles) or any(
            abs(c[0] - cycles[0][0]) > FLAT_BYTES for c in cycles):
        raise AssertionError(f"serve steps {label}: jitted() over {F1_CYCLES} prefill -> "
                             f"decode cycles (allocated bytes, captures, live graphs) {cycles}")
    pg, = pj.graphs.graphs.values()
    dg, = dj.graphs.graphs.values()
    if any(a is not b for a, b in zip(tree_leaves(cache["layers"]), dg.cache, strict=True)):
        raise AssertionError(f"serve steps {label}: jitted() decode returned a cache other "
                             "than its graph's buffers")
    rows = [_check_program(f"serve steps {label} prefill", ("prefill",), pg.prog, []),
            _check_program(f"serve steps {label} decode", ("decode",), dg.prog,
                           [(t, False) for t in dg.cache])]
    log(f"serve steps {label} jitted(): {F1_CYCLES} prefill -> {len(want_toks)}-step decode "
        f"cycles, prefill logits and every step's tokens equal to the eager step's; "
        f"(captures, live graphs) prefill / decode {cycles[-1][1]} / {cycles[-1][2]}; device "
        f"memory allocated after each cycle " + ", ".join(str(c[0]) for c in cycles)
        + f" bytes; decode step median {steady:.2f} ms after its capture (eager "
        f"{eager_ms:.2f}); pools prefill {pj.graphs.pool_bytes() / 1e6:.1f} MB, decode "
        f"{dj.graphs.pool_bytes() / 1e6:.1f} MB")
    for r in rows:
        log(f"serve steps {label} graph {r['program']}: bit-equal to its eager call; eager "
            f"{r['eager_ms']:.3f} ms, replay {r['replay_ms']:.3f} ms "
            f"({r['eager_ms'] / r['replay_ms']:.1f}x), {r['launches']} launches a replay "
            f"(counted), kernels {json.dumps(r['kernels'])}, capture {r['capture_s']:.2f}s")
    del cache
    return first


def _clone_cache(cache):
    return {"index": cache["index"].clone(),
            "layers": {k: v.clone() for k, v in cache["layers"].items()}}


def _cache_gb(cache) -> float:
    from repro_torch.tree import tree_leaves

    return sum(t.numel() * t.element_size() for t in tree_leaves(cache["layers"])) / 1e9


def _fp8_serve_steps(cfg, mesh, params, local, prompts, bf16_step_ms, bf16_peak, total):
    """Phase 33 over an 8-bit cache: ``make_prefill_step`` + the decode steps
    of ``cfg`` with ``cache_dtype=float8_e4m3fn`` on ``mesh`` (bf16 weights
    and compute): the prefill's logits and cache bit-equal to ``T.prefill``'s
    with the same cache dtype; each step's tokens against the same step on
    the plain versions from the same cache and token (``T.decode_step`` with
    ``attn_impl="torch"``: #3's plain version over the same 8-bit rows),
    differing only at a bf16 tie (``FP8_TIE_ULPS``), and equal in fp32
    compute (``_fp8_fp32_tokens``); #3's fp8 instantiation launched once a
    layer and step; the first decode step's logits against the same step
    over the bf16 cache, cosine >= ``FP8_MIN_COSINE``; cache bytes, peak
    memory and the decode step's time beside the bf16 cache's.  For
    qwen3-1.7b also the 8 x ``FP8_LONG_SEQ`` cache in both types.  Adds the
    launches to ``total`` and returns it."""
    import torch

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.runtime import make_prefill_step, make_serve_step

    fp8 = torch.float8_e4m3fn
    arch = cfg.name
    shape = ShapeConfig("serve_steps", SERVE_STEP_SEQ, SERVE_STEP_ROWS, "decode")
    pre = make_prefill_step(cfg, mesh, shape, cache_dtype=fp8)
    dec = make_serve_step(cfg, mesh, shape, cache_dtype=fp8)
    inputs = pre.shard_inputs(prompts)
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    (logits, cache), pre_s = _timed(pre.step, local, inputs)
    peak = torch.cuda.max_memory_allocated()
    cache_gb = _cache_gb(cache)
    tok0 = torch.argmax(pre.gather_output(logits), -1).to(torch.int32)
    tok, step_s, plain = tok0, [], []
    for _ in range(SERVE_STEP_DECODES):
        # the same step on the plain versions, from the same cache and token
        # (#3's plain version over the same 8-bit rows; counted apart), then
        # the step, its peak memory taken alone
        with torch.no_grad():
            lg = T.decode_step(cfg, params, tok, _clone_cache(cache), attn_impl="torch")[0]
        torch.cuda.reset_peak_memory_stats()
        (tok, cache), dt = _timed(dec.step, local, tok, cache)
        peak = max(peak, torch.cuda.max_memory_allocated())
        plain.append((lg, tok))
        step_s.append(dt)
    counts = ops.launch_counts()
    peak /= 1e9
    want = {"flash_attention_fwd": cfg.num_layers,
            "decode_attention_fp8": cfg.num_layers * SERVE_STEP_DECODES,
            "decode_attention": 0}
    got = {n: counts[n]["cuda"] for n in want}
    if got != want:
        raise AssertionError(f"fp8 serve steps {arch}: launches {got}, expected {want}")
    med = sorted(step_s)[len(step_s) // 2] * 1e3
    jit_counts = _jitted_serve_steps(f"{arch} e4m3", pre, dec, local, inputs, logits,
                                     [t for _, t in plain], want, med)
    for n in counts:
        total[n] = total.get(n, 0) + counts[n]["cuda"] + jit_counts[n]["cuda"]
    with torch.no_grad():
        ref_logits, ref_cache = T.prefill(cfg, params, prompts, SERVE_STEP_SEQ, cache_dtype=fp8)
        fresh = pre.step(local, inputs)[1]
        same_cache = all(torch.equal(fresh["layers"][n].view(torch.uint8),
                                     ref_cache["layers"][n].view(torch.uint8))
                         for n in ("k", "v"))
        # the first decode step over each cache, from the same prompt and token
        lg8 = T.decode_step(cfg, params, tok0, fresh)[0].float()
        bf16 = make_prefill_step(cfg, mesh, shape).step(local, inputs)[1]
        bf16_gb = _cache_gb(bf16)
        lg16 = T.decode_step(cfg, params, tok0, bf16)[0].float()
    cos = ((lg8 * lg16).sum() / (lg8.norm() * lg16.norm())).item()
    row_cos = torch.nn.functional.cosine_similarity(lg8, lg16, dim=-1).min().item()
    if not (torch.equal(logits, ref_logits) and same_cache):
        raise AssertionError(f"fp8 serve steps {arch}: the prefill's logits or 8-bit cache "
                             "differ from T.prefill's")
    flips = _fp8_token_flips(plain)
    far = [f for f in flips
           if f[2] > FP8_TIE_ULPS * 2.0 ** (math.floor(math.log2(max(abs(f[3]), 1e-30))) - 7)]
    if far:
        raise AssertionError(f"fp8 serve steps {arch}: tokens differ from the plain versions' "
                             f"beyond a bf16 tie (step, row, plain logit margin, logit): {far}")
    if not cos >= FP8_MIN_COSINE:
        raise AssertionError(f"fp8 serve steps {arch}: logits cosine {cos:.5f} against the "
                             f"bf16 cache's (at least {FP8_MIN_COSINE})")
    log(f"fp8 serve steps ({_card()}; {arch} full depth, bf16 weights and compute, "
        f"cache_dtype=float8_e4m3fn, {SERVE_STEP_ROWS} rows x {SERVE_STEP_PROMPT}-token prompts "
        f"in {SERVE_STEP_SEQ} rows): prefill logits and cache bit-equal to T.prefill's; tokens "
        f"of {SERVE_STEP_DECODES} steps, each against the same step on the plain versions "
        f"from the same cache, {len(flips)} differ; first-step logits cosine "
        f"{cos:.5f} against the bf16 cache's (rows min {row_cos:.5f}); cache {cache_gb:.4f} GB "
        f"(bf16 {bf16_gb:.4f}); peak {peak:.2f} GB (bf16 run {bf16_peak:.2f}); prefill "
        f"{pre_s * 1e3:.1f} ms; decode step median {med:.2f} ms (bf16 cache "
        f"{bf16_step_ms:.2f}); launches {json.dumps(got)}")
    del cache, fresh, bf16, ref_cache
    exact = _fp8_fp32_tokens(cfg, mesh, prompts)
    log(f"fp8 serve steps {arch}: bf16 tokens at a tie with the plain versions' (step, row, "
        f"plain logit margin, logit): {flips}; in fp32 compute {exact} steps x "
        f"{SERVE_STEP_ROWS} rows equal to the plain versions'")
    if arch.startswith("qwen3"):
        _fp8_long_cache(cfg, mesh, local, prompts)
    return total


def _fp8_token_flips(steps) -> list:
    """``(step, row, margin, logit)`` where a step's token differs from the
    plain version's argmax of ``lg`` (``steps``: (plain logits, token) a
    step): the plain logits' margin of its own argmax over the step's token."""
    import torch

    flips = []
    for i, (lg, tok) in enumerate(steps):
        want = torch.argmax(lg, -1).to(torch.int32)
        for r in torch.nonzero(want != tok).flatten().tolist():
            row = lg[r].float()
            flips.append((i, r, (row[want[r]] - row[tok[r]]).item(), row[want[r]].item()))
    return flips


def _fp8_fp32_tokens(cfg, mesh, prompts) -> int:
    """The 8-bit cache's serve steps in fp32 compute (weights from their own
    seed): each decode step's tokens equal to the same step on the plain
    versions from the same cache and token (``attn_impl="torch"``), exactly.
    Returns the steps checked."""
    import torch

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import transformer as T
    from repro_torch.runtime import make_prefill_step, make_serve_step

    f32, fp8 = torch.float32, torch.float8_e4m3fn
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(39), dtype=f32)
    shape = ShapeConfig("serve_steps", SERVE_STEP_SEQ, SERVE_STEP_ROWS, "decode")
    pre = make_prefill_step(cfg, mesh, shape, compute_dtype=f32, cache_dtype=fp8)
    dec = make_serve_step(cfg, mesh, shape, compute_dtype=f32, cache_dtype=fp8)
    local = pre.shard_params(params)
    logits, cache = pre.step(local, pre.shard_inputs(prompts))
    tok, steps = torch.argmax(pre.gather_output(logits), -1).to(torch.int32), []
    for _ in range(SERVE_STEP_DECODES):
        with torch.no_grad():
            lg = T.decode_step(cfg, params, tok, _clone_cache(cache), compute_dtype=f32,
                               attn_impl="torch")[0]
        tok, cache = dec.step(local, tok, cache)
        steps.append((lg, tok))
    flips = _fp8_token_flips(steps)
    if flips:
        raise AssertionError(f"fp8 serve steps {cfg.name}, fp32: tokens differ from the plain "
                             f"versions' (step, row, plain logit margin, logit): {flips}")
    del params, local, cache
    return len(steps)


def _fp8_long_cache(cfg, mesh, local, prompts):
    """qwen3-1.7b's 8 x ``FP8_LONG_SEQ`` cache in bf16 and in fp8: the serve
    steps' prefill and ``FP8_LONG_DECODES`` decode steps; cache bytes, peak
    memory, the decode step's median time."""
    import torch

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.runtime import make_prefill_step, make_serve_step

    shape = ShapeConfig("serve_steps_long", FP8_LONG_SEQ, SERVE_STEP_ROWS, "decode")
    out = {}
    for name, dtype in (("bf16", None), ("fp8", torch.float8_e4m3fn)):
        pre = make_prefill_step(cfg, mesh, shape, cache_dtype=dtype)
        dec = make_serve_step(cfg, mesh, shape, cache_dtype=dtype)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        logits, cache = pre.step(local, pre.shard_inputs(prompts))
        tok = torch.argmax(pre.gather_output(logits), -1).to(torch.int32)
        step_s = []
        for _ in range(FP8_LONG_DECODES):
            (tok, cache), dt = _timed(dec.step, local, tok, cache)
            step_s.append(dt)
        out[name] = (_cache_gb(cache), torch.cuda.max_memory_allocated() / 1e9,
                     sorted(step_s)[len(step_s) // 2] * 1e3)
        del cache, logits
    log(f"fp8 serve steps ({_card()}; {cfg.name}, {SERVE_STEP_ROWS} x {FP8_LONG_SEQ} cache, "
        f"{FP8_LONG_DECODES} decode steps): cache GB bf16 {out['bf16'][0]:.4f} / fp8 "
        f"{out['fp8'][0]:.4f}; peak GB {out['bf16'][1]:.2f} / {out['fp8'][1]:.2f}; decode step "
        f"median ms {out['bf16'][2]:.2f} / {out['fp8'][2]:.2f}")


def _fp8_seq_parallel_serve(total):
    """The sequence-parallel decode over an 8-bit cache: ``_stand_in_serve``
    of qwen3-1.7b cut to ``FP8_SP_LAYERS`` layers on the (1, ``SP_RANKS``)
    stand-in mesh with ``cache_dtype=float8_e4m3fn``: each rank runs #3's
    partial form over its block of 8-bit rows once a layer and step.  Adds
    its launches to ``total`` and returns it."""
    import dataclasses

    import torch

    from repro_torch import configs

    cfg = dataclasses.replace(configs.get_config(SP_ARCH), num_layers=FP8_SP_LAYERS)
    counts, sp = _stand_in_serve(cfg, SP_RANKS, SERVE_STEP_ROWS, SERVE_STEP_SEQ, SP_PROMPT,
                                 SP_DECODES, seed=36, cache_dtype=torch.float8_e4m3fn,
                                 rtol=FP8_SP_RTOL)
    want = SP_RANKS * FP8_SP_LAYERS * SP_DECODES
    got = {n: counts[n]["cuda"] for n in ("decode_attention_partial_fp8",
                                          "decode_attention_partial", "combine_splits")}
    if got != {"decode_attention_partial_fp8": want, "decode_attention_partial": 0,
               "combine_splits": want}:
        raise AssertionError(f"fp8 seq parallel serve: launches {got}, expected {want} 8-bit "
                             "partials and merges")
    for n, c in counts.items():
        total[n] = total.get(n, 0) + c["cuda"]
    log(f"fp8 seq parallel serve ({_card()}; {SP_ARCH} full width cut to {FP8_SP_LAYERS} "
        f"layers, fp32, cache_dtype=float8_e4m3fn, (1, {SP_RANKS}) stand-in mesh): tokens equal "
        f"to the unsplit run's, errors {sp['errors']} (logits within {FP8_SP_RTOL:g} of the max; "
        f"cache codes next to the unsplit run's on at most {FP8_STRADDLE_SHARE:g} of the "
        f"entries); {sp['seconds']:.1f} s; launches {json.dumps(got)}")
    return total


def _fsdp_serve_steps():
    """The FSDP serve steps: ``_stand_in_serve`` of qwen3-1.7b (full width
    and depth, fp32) on a (data, model) = ``FSDP_SERVE_MESH`` stand-in mesh
    with ``fsdp=True``: the tokens equal to the unsplit run's; each rank's
    most gathered bytes alive at once no more than one layer's gathered
    weights plus every split leaf outside the stacks, printed beside the
    whole tree's (what the whole-tree gather held) and the device's peak
    above the memory before the run."""
    import torch

    from repro_torch import configs
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.runtime import make_serve_step
    from repro_torch.runtime.step import abstract_params
    from repro_torch.tree import tree_map_with_path

    cfg = configs.get_config(SP_ARCH)
    ranks = FSDP_SERVE_MESH[0] * FSDP_SERVE_MESH[1]
    _, sp = _stand_in_serve(cfg, ranks, SERVE_STEP_ROWS, SERVE_STEP_SEQ, SP_PROMPT,
                            SP_DECODES, seed=37, mesh_shape=FSDP_SERVE_MESH, fsdp=True)
    # the bound from the specs: a layer's gathered fp32 weights and every
    # split leaf outside the stacks; and the whole tree's split leaves
    mesh = _ThreadMesh(_Turns(ranks), FSDP_SERVE_MESH, ("data", "model"), 0, "meta")
    art = make_serve_step(cfg, mesh, ShapeConfig("fsdp", SERVE_STEP_SEQ, SERVE_STEP_ROWS,
                                                  "decode"), compute_dtype=torch.float32,
                          fsdp=True)
    sizes = []
    tree_map_with_path(lambda path, t, spec: sizes.append(
        (path.startswith("layers/"), t.numel() * 4, any(e is not None for e in spec))),
        abstract_params(cfg), art.param_specs)
    layer = sum(n // cfg.num_layers for stacked, n, split in sizes if split and stacked)
    top = sum(n for stacked, n, split in sizes if split and not stacked)
    whole = sum(n for _, n, split in sizes if split)
    worst = max(sp["gathered"])
    if not 0 < worst <= layer + top:
        raise AssertionError(f"fsdp serve steps: {worst} gathered bytes alive at once, above "
                             f"one layer's {layer} + the non-layer split leaves' {top}")
    log(f"fsdp serve steps ({_card()}; {SP_ARCH} full width and depth, fp32, fsdp=True on a "
        f"(data, model) = {FSDP_SERVE_MESH} stand-in mesh, {SERVE_STEP_ROWS // ranks} of "
        f"{SERVE_STEP_ROWS} rows a rank): tokens equal to the unsplit run's, errors "
        f"{sp['errors']}; most gathered bytes alive at once by rank {sp['gathered']} (bound "
        f"{layer + top}: a layer {layer} + the non-layer split leaves {top}; the whole-tree "
        f"gather held {whole}); shard bytes by rank {sp['shard_bytes']}; device peak above "
        f"the memory before the run {sp['peak_above_base_gb']:.2f} GB (every rank's shards and "
        f"cache, one rank's gathered layer at a time); {sp['seconds']:.1f} s; rank 0's "
        f"collectives {json.dumps(sp['collectives_rank0'])}")


# ---------------------------------------------------------------------------
# 34. Mamba1 and the hybrid over the model axis: the serve steps on a stand-in
# mesh, the scan #10 / #10b at a rank's d_inner
# ---------------------------------------------------------------------------

#: the stand-in mesh's model axis: falcon-mamba's d_inner 8192 in blocks of
#: 2048, zamba2's 80 SSM heads in blocks of 20 and its 32 attention heads
#: (KV heads too) in blocks of 8
SSM_TP_RANKS = 4
#: 8 rows of a 128-token prompt (two whole SSD chunks) in a 512-row cache,
#: 8 decode steps
SSM_TP_ROWS, SSM_TP_PROMPT, SSM_TP_SEQ, SSM_TP_DECODES = 8, 128, 512, 8
#: the scan's rank shapes: d_inner 8192 over model 2 and 4 (B = 4, Q = 1024
#: and a ragged 200), and the smoke config's 128 over model 4 at its state
#: width 8 (B = 2, Q = 65)
SSM_TP_DI = (4096, 2048)
SSM_TP_CASES = [(4, 1024, di, SSM_DS) for di in SSM_TP_DI] + \
    [(4, 200, di, SSM_DS) for di in SSM_TP_DI] + [(2, 65, 32, 8)]


def _ssm_rank_shapes():
    """#10 and #10b at a rank's ``d_inner`` (``SSM_TP_CASES``, fp32, from a
    non-zero h0, with a non-zero gradient of the final state): the serving
    forward against the plain scan, the backward against autograd of it,
    each within ``SSM_RTOL`` / ``SSM_GRAD_RTOL`` of the largest value and
    bit-equal over two launches; then each timed at B = 4, Q = 1024 beside
    its plain version and its bound.  Returns ``{d_inner: (forward ms,
    plain ms, bound ms, by, backward ms, plain ms, bound ms, by)}`` and the
    worst errors ``(forward, backward)``."""
    import torch

    from repro_torch.kernels import ssm_scan as ss

    def plain_graph(args):
        leaves = [a.detach().clone().requires_grad_() for a in args]
        return leaves, ss.ssm_scan_chunk_torch(*leaves)

    rel = lambda a, r: ((a - r).abs().max() / r.abs().max()).item()
    worst = [0.0, 0.0]
    for b, q, di, ds in SSM_TP_CASES:
        args = _ssm_inputs(b, q, seed=34, di=di, ds=ds)
        g = torch.Generator(device="cuda").manual_seed(35)
        gy = torch.randn((b, q, di), generator=g, device="cuda")
        gh = torch.randn((b, di, ds), generator=g, device="cuda")
        y, h = ss.ssm_scan_chunk(*args)
        y2, h2 = ss.ssm_scan_chunk(*args)
        _, _, hs = ss.ssm_scan_fwd(*args)
        kgrads = ss.ssm_scan_bwd(*args[:5], hs, gy, gh)
        again = ss.ssm_scan_bwd(*args[:5], hs, gy, gh)
        torch.cuda.synchronize()
        label = f"B={b} Q={q} di={di} ds={ds}"
        if not (torch.equal(y, y2) and torch.equal(h, h2)
                and all(torch.equal(k, k2) for k, k2 in zip(kgrads, again))):
            raise AssertionError(f"ssm_scan / ssm_scan_bwd {label}: two launches differ")
        ry, rh = ss.ssm_scan_chunk_torch(*args)
        leaves, outs = plain_graph(args)
        pgrads = torch.autograd.grad(outs, leaves, (gy, gh))
        fwd = max(rel(y, ry), rel(h, rh))
        bwd = max(rel(k, p) for k, p in zip(kgrads, pgrads))
        finite = all(torch.isfinite(t).all() for t in (y, h, *kgrads))
        log(f"kernel ssm_scan / ssm_scan_bwd at a rank's d_inner, {label} fp32: forward max err "
            f"/ max|ref| {fwd:.2e} (tol {SSM_RTOL:g}), backward {bwd:.2e} (tol "
            f"{SSM_GRAD_RTOL:g}); two launches of each bit-equal")
        if not (finite and fwd <= SSM_RTOL and bwd <= SSM_GRAD_RTOL):
            raise AssertionError(f"ssm_scan at a rank's d_inner {label}: errors {fwd}, {bwd} "
                                 "or non-finite values")
        worst = [max(worst[0], fwd), max(worst[1], bwd)]
        del leaves, outs, pgrads, kgrads, again
    times = {}
    b, q = 4, 1024
    for di in SSM_TP_DI:
        args = _ssm_inputs(b, q, seed=36, di=di)
        g = torch.Generator(device="cuda").manual_seed(37)
        gy = torch.randn((b, q, di), generator=g, device="cuda")
        gh = torch.randn((b, di, SSM_DS), generator=g, device="cuda")
        _, _, hs = ss.ssm_scan_fwd(*args)
        f_ms = _time_ms(lambda: ss.ssm_scan_chunk(*args))
        fp_ms = _time_ms(lambda: ss.ssm_scan_chunk_torch(*args), reps=3)
        b_ms = _time_ms(lambda: ss.ssm_scan_bwd(*args[:5], hs, gy, gh))
        leaves, outs = plain_graph(args)
        bp_ms = _time_ms(lambda: torch.autograd.grad(outs, leaves, (gy, gh), retain_graph=True),
                         reps=3)
        del leaves, outs
        f_bound, f_by = _ssm_bound(q, b, di=di)
        b_bound, b_by = _ssm_bwd_bound(b, q, di=di)
        times[di] = (f_ms, fp_ms, f_bound, f_by, b_ms, bp_ms, b_bound, b_by)
        log(f"kernel ssm_scan at a rank's d_inner ({_card()}; B={b}, Q={q}, di={di}, "
            f"ds={SSM_DS}, fp32): forward {f_ms:.4f} ms (plain {fp_ms:.4f}, bound {f_bound:.4f} "
            f"by {f_by}, {100 * f_bound / f_ms:.1f}%); backward {b_ms:.4f} ms (plain "
            f"{bp_ms:.4f}, bound {b_bound:.4f} by {b_by}, {100 * b_bound / b_ms:.1f}%); "
            f"library none")
    return times, worst


def phase_ssm_model_axis():
    """Phase 34: Mamba1 and the hybrid over the model axis.  The serve steps
    (``make_prefill_step`` + ``SSM_TP_DECODES`` ``make_serve_step`` steps, fp32)
    of falcon-mamba-7b and zamba2-2.7b at full width and depth on a
    ``(1, SSM_TP_RANKS)`` stand-in mesh (``_stand_in_serve``), each rank on
    its ``d_inner`` block, against the unsplit run; the scan #10 and its
    backward #10b at a rank's ``d_inner`` (``_ssm_rank_shapes``).  Returns
    the runs' launch counts and the kernel row of #10 at falcon-mamba's
    rank shape (its launches: the stand-in run's)."""
    import torch

    from repro_torch import configs

    t_phase = time.monotonic()
    _fresh_phase()
    runs, summaries = {}, {}
    for arch, kernels in (("falcon-mamba-7b", SSM_KERNELS),
                          ("zamba2-2.7b", HYBRID_SERVE_KERNELS)):
        cfg = configs.get_config(arch)
        t0 = time.monotonic()
        counts, sm = _stand_in_serve(cfg, SSM_TP_RANKS, SSM_TP_ROWS, SSM_TP_SEQ, SSM_TP_PROMPT,
                                     SSM_TP_DECODES, seed=34)
        _require_launches(f"{arch} over model {SSM_TP_RANKS}", counts, kernels)
        n = SSM_TP_RANKS
        if cfg.family == "ssm":
            want = {"ssm_scan": n * cfg.num_layers}
            width = [loc["h"][2] for loc in sm["local"]]
        else:
            n_cyc = cfg.num_layers // cfg.shared_attn_every
            want = {"flash_attention_fwd": n * n_cyc,
                    "decode_attention": n * n_cyc * SSM_TP_DECODES}
            width = [loc["mamba"]["conv_x"][-1] for loc in sm["local"]]
            if any(loc["shared_k"][3] != cfg.num_kv_heads // n for loc in sm["local"]):
                raise AssertionError(f"{arch}: the shared K/V do not split their heads: "
                                     f"{[loc['shared_k'] for loc in sm['local']]}")
        got = {k: counts[k]["cuda"] for k in want}
        if got != want or width != [cfg.d_inner // n] * n:
            raise AssertionError(f"{arch} over model {n}: launches {got} (expected {want}), "
                                 f"d_inner a rank {width}")
        peak = torch.cuda.max_memory_allocated() / 1e9
        log(f"ssm model axis ({_card()}; {arch} full width and depth, fp32, make_prefill_step + "
            f"{SSM_TP_DECODES} make_serve_step steps on a (1, {n}) stand-in mesh of threads, "
            f"{SSM_TP_ROWS} rows of {SSM_TP_PROMPT}-token prompts, d_inner {cfg.d_inner // n} a "
            f"rank): tokens equal to the unsplit T.prefill + T.decode_step, errors relative to "
            f"the max {sm['errors']} (tolerance {SP_RTOL:g}); {sm['seconds']:.1f} s for all "
            f"ranks in turn, {time.monotonic() - t0:.1f} s with the unsplit run; peak "
            f"{peak:.2f} GB; rank 0's collectives {json.dumps(sm['collectives_rank0'])}; "
            f"launches {json.dumps(got)}")
        runs[f"ssm_tp_{cfg.family}"] = {k: c["cuda"] for k, c in counts.items()}
        summaries[arch] = sm
        _fresh_phase()
    times, worst = _ssm_rank_shapes()
    di = SSM_TP_DI[-1]  # falcon-mamba's d_inner a rank at model 4: the stand-in's
    f_ms, fp_ms, f_bound, f_by, b_ms, bp_ms, b_bound, b_by = times[di]
    row = {"name": f"ssm_scan_di{di}", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/ssm_scan.cu",
           "replaces": "src/repro/kernels/ssm_scan.py:56",
           "launches": runs["ssm_tp_ssm"]["ssm_scan"], "max_abs_err": worst[0],
           "err_kind": "relative to max|ref|, fp32", "ms": f_ms, "plain_ms": fp_ms,
           "bound_ms": f_bound, "bound_by": f_by, "library_ms": None,
           "shape": f"B=4, Q=1024, di={di}, ds={SSM_DS}",
           "bwd": {str(d): {"ms": t[4], "plain_ms": t[5], "bound_ms": t[6], "bound_by": t[7]}
                   for d, t in times.items()},
           "fwd_di4096": {"ms": times[4096][0], "plain_ms": times[4096][1],
                          "bound_ms": times[4096][2]},
           "max_abs_err_bwd": worst[1]}
    _end_phase("ssm model axis")
    log(f"ssm model axis: {time.monotonic() - t_phase:.1f}s")
    return runs, [row]


# ---------------------------------------------------------------------------
# 35. the cost model against the card
# ---------------------------------------------------------------------------

#: phase 35's timed warm runs of each step (the median is reported)
COST_TIMED_RUNS = 3


def _profiled_launches(fn) -> tuple:
    """``fn()`` once under ``torch.profiler``: (device events by name, the
    number of kernel events, the number of all device events)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names: dict = {}
    kernels = events = 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            names[e.name] = names.get(e.name, 0) + 1
            events += 1
            kernels += not e.name.startswith(("Memcpy", "Memset"))
    return names, kernels, events


def _cost_against_card(label, counted, fn, model_flops, base_bytes):
    """Time ``fn`` warm (``COST_TIMED_RUNS`` runs, after one untimed), run
    it once under the profiler, hold each hand-written kernel's counted
    launches to the profiler's count of it and log the comparison."""
    import re

    import torch

    from repro_torch.core.hardware import H100
    from repro_torch.kernels import cost as kcost
    from repro_torch.launch.roofline import roofline_terms

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(COST_TIMED_RUNS):
        times.append(_timed(fn)[1])
    step_s = sorted(times)[len(times) // 2]
    torch.cuda.reset_peak_memory_stats()
    names, kernels, events = _profiled_launches(fn)
    peak = torch.cuda.max_memory_allocated() - base_bytes
    profiled = {sym: sum(n for name, n in names.items() if re.search(rf"\b{sym}\b", name))
                for sym in kcost.SYMBOLS}
    hand = {sym: (counted["kernels"].get(sym, 0), n) for sym, n in profiled.items()
            if n or counted["kernels"].get(sym, 0)}
    bad = {sym: c for sym, c in hand.items() if c[0] != c[1]}
    if bad or not hand:
        raise AssertionError(f"cost model {label}: counted / profiled launches of the "
                             f"hand-written kernels {hand} (differ: {bad})")
    roof = roofline_terms(parsed=counted, n_devices=1, model_flops=model_flops, hw=H100)
    mfu = model_flops / (step_s * H100.peak_flops)
    mem = counted["memory"]["peak_bytes_per_device"]
    log(f"cost model {label} ({_card()}): hand-written kernels counted = profiled "
        f"{json.dumps({k: v[0] for k, v in hand.items()})}; all launches counted "
        f"{counted['launches']} / profiled kernels {kernels} = "
        f"{counted['launches'] / kernels:.3f} (device events {events}, ratio "
        f"{counted['launches'] / events:.3f}); peak counted {mem / 1e9:.3f} GB / "
        f"max_memory_allocated {peak / 1e9:.3f} GB = {mem / peak:.3f}; counted FLOPs "
        f"{counted['flops']:.4e}, bytes {counted['bytes_accessed']:.4e}; roofline on "
        f"{H100.name} (modelled) compute {roof.compute_s * 1e3:.3f} ms, memory "
        f"{roof.memory_s * 1e3:.3f} ms, collective {roof.collective_s * 1e3:.3f} ms "
        f"({roof.dominant}); measured step {step_s * 1e3:.2f} ms (runs "
        + ", ".join(f"{t * 1e3:.2f}" for t in times) + f"); mfu {mfu:.4f}; bound share "
        f"{roof.bound_s / step_s:.4f}")


def phase_cost_model():
    """Phase 35: ``launch.cost`` against the card on olmo-1b at full depth:
    phase 30's train step and phase 33's bf16 prefill and decode step on a
    one-rank NCCL mesh, each counted on a (1, 1) ``RecordingMesh``."""
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.configs import TrainConfig
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import SyntheticDataset
    from repro_torch.launch import cells, cost
    from repro_torch.launch.mesh import make_dev_mesh
    from repro_torch.models import transformer as T
    from repro_torch.runtime import make_prefill_step, make_serve_step, make_train_step

    t_phase = time.monotonic()
    cfg = configs.get_config("olmo-1b")
    rec = cost.RecordingMesh((1, 1), ("data", "model"))
    store = tempfile.mkdtemp(prefix="cost_model_")
    dist.init_process_group("nccl", init_method=f"file://{store}/store", rank=0, world_size=1)
    try:
        mesh = make_dev_mesh(device="cuda")
        # the train step: phase 30's settings
        _fresh_phase()
        base = torch.cuda.memory_allocated()
        tcfg = TrainConfig(warmup_steps=2, total_steps=SCALE_STEPS + 8, remat_policy="full",
                           fsdp=True, zero1=True)
        shape = ShapeConfig("phase35_train", TRAIN_S, TRAIN_B, "train")
        t0 = time.monotonic()
        counted = cells.Cell("olmo-1b", shape, cfg, "train",
                             make_train_step(cfg, tcfg, rec, device="meta")).count()
        count_s = time.monotonic() - t0
        step = make_train_step(cfg, tcfg, mesh, device="cuda")
        state = step.init_state(T.init_params(cfg, torch.Generator(device="cuda").manual_seed(35)))
        ds = SyntheticDataset(cfg=cfg, seq_len=TRAIN_S, global_batch=TRAIN_B, seed=35)
        batch = step.shard_batch(ds.next_batch())
        log(f"cost model train: counted in {count_s:.1f} s on meta")
        _cost_against_card("olmo-1b train step (4 x 1024, FSDP + ZeRO-1, remat full)", counted,
                           lambda: step(state, batch), cells.model_flops(cfg, shape), base)
        del state, batch, step
        # the serve steps: phase 33's bf16 prefill and decode step
        _fresh_phase()
        base = torch.cuda.memory_allocated()
        shape = ShapeConfig("serve_steps", SERVE_STEP_SEQ, SERVE_STEP_ROWS, "decode")
        cpre, cdec = make_prefill_step(cfg, rec, shape), make_serve_step(cfg, rec, shape)
        params_abs, tokens_abs, cache_abs = cdec.abstract_inputs()
        local_abs = cells.own(cpre.shard_params(params_abs))
        prompt_abs = torch.empty((SERVE_STEP_ROWS, SERVE_STEP_PROMPT), dtype=torch.int32,
                                 device="meta")
        t0 = time.monotonic()
        pre_counted = cost.analyze(cpre.step, local_abs, prompt_abs)
        dec_counted = cost.analyze(cdec.step, local_abs, cells.own(tokens_abs),
                                   cells.own(cache_abs))
        count_s = time.monotonic() - t0
        pre, dec = make_prefill_step(cfg, mesh, shape), make_serve_step(cfg, mesh, shape)
        gen = torch.Generator(device="cuda").manual_seed(35)
        local = pre.shard_params(T.init_params(cfg, gen, dtype=torch.bfloat16))
        prompts = torch.randint(0, cfg.vocab_size, (SERVE_STEP_ROWS, SERVE_STEP_PROMPT),
                                generator=gen, device="cuda", dtype=torch.int32)
        log(f"cost model serve steps: counted in {count_s:.1f} s on meta (the decode's "
            f"cache counted full: {SERVE_STEP_SEQ} live rows)")
        prefill_shape = ShapeConfig("phase35_prefill", SERVE_STEP_PROMPT, SERVE_STEP_ROWS,
                                    "prefill")
        _cost_against_card(f"olmo-1b bf16 prefill ({SERVE_STEP_ROWS} x {SERVE_STEP_PROMPT} "
                           f"into {SERVE_STEP_SEQ} rows)", pre_counted,
                           lambda: pre.step(local, prompts),
                           cells.model_flops(cfg, prefill_shape), base)
        # each decode step writes the next row of the prefill's cache
        logits, cache = pre.step(local, prompts)
        run = {"tok": torch.argmax(logits, -1).to(torch.int32), "cache": cache}

        def decode():
            run["tok"], run["cache"] = dec.step(local, run["tok"], run["cache"])

        _cost_against_card(f"olmo-1b bf16 decode step ({SERVE_STEP_ROWS} rows, "
                           f"{SERVE_STEP_SEQ}-row cache)", dec_counted, decode,
                           cells.model_flops(cfg, shape), base)
        del local, cache, run, logits
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    _end_phase("cost model")
    log(f"cost model: {time.monotonic() - t_phase:.1f}s")


# ---------------------------------------------------------------------------
# 36. graphs: the serving programs as CUDA graphs against their eager calls
# ---------------------------------------------------------------------------

#: timed calls of each program, eager and replayed (the median is printed)
GRAPH_REPS = 5
#: the phase's qwen3-1.7b engines: (label, engine settings, draft paired)
GRAPH_QWEN_ENGINES = (
    ("paged chunked", {}, False),
    ("paged chunked + draft", {}, True),
    ("dense chunked", {"kv_page_size": 0}, False),
    ("dense chunked + draft", {"kv_page_size": 0}, True),
    ("paged monolithic + draft", {"prefill_chunk": 0}, True),
)


def _tree_graphs(label, engine):
    """The tree graphs of ``engine``, which must be one per distinct
    ``(parents, mode)`` its rounds ran; returns a summary."""
    graphed = {key[1:] for key in engine._graphs if key[0] == "tree"}
    if graphed != set(engine._tree_round_cache):
        raise AssertionError(f"graphs {label}: tree graphs {sorted(graphed)} for the "
                             f"topologies run {sorted(engine._tree_round_cache)}")
    return (f"{len(graphed)} tree graphs = distinct (parents, mode) run "
            f"{sorted((len(p), m) for p, m in graphed)} (nodes, mode)")


class _EagerGraphs:
    """Mixed into an ``InferenceEngine`` subclass: the same engine with
    every program run eagerly on the card (the kernels still launch), the
    baseline a replay is held to."""

    graphs = False


def _cache_leaves(engine):
    """Every cache tensor a program writes: (tensor, whether it is a paged
    pool, whose sentinel page 0 takes colliding pad writes)."""
    from repro_torch.tree import tree_leaves

    out = [(t, engine.paged) for t in tree_leaves(engine.cache["layers"])]
    if engine.draft_cache is not None:
        out += [(t, False) for t in tree_leaves(engine.draft_cache["layers"])]
    return out


def _median_ms(fn, reps=GRAPH_REPS):
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2]


def _check_graph_program(label, engine, key, prog):
    """``_check_program`` of one of ``engine``'s programs over its cache
    and its generator."""
    return _check_program(label, key, prog, _cache_leaves(engine), engine._spec_gen)


def _check_program(label, key, prog, leaves, gen=None):
    """One captured program (a ``GraphProgram``) on its last replay's
    inputs: eager and replay timed, its launches counted over the eager
    program (``launch.cost.CountingMode``, the kernels priced, not run), and
    the replay's outputs and every tensor of ``leaves`` (``(tensor, is a
    paged pool)``: what it writes in place) bit-equal to the eager call's
    from the same state (and the same state of ``gen``).  The tensors and
    the generator are put back after.  Returns the program's row."""
    import torch

    from repro_torch.launch.cost import CountingMode

    inputs = {k: v.clone() for k, v in prog.static.items()}
    saved = [t.clone() for t, _ in leaves]
    g0 = None if gen is None else gen.get_state()

    def restore():
        for (t, _), s in zip(leaves, saved):
            t.copy_(s)
        if gen is not None:
            gen.set_state(g0)

    eager_ms = _median_ms(lambda: prog.eager(inputs))
    restore()
    replay_ms = _median_ms(lambda: prog.replay(inputs))
    restore()
    with CountingMode() as mode:
        prog.eager(inputs)
    torch.cuda.synchronize()
    restore()
    want = [t.clone() for t in prog.eager(inputs)]
    want_cache = [t.clone() for t, _ in leaves]
    restore()
    # an ``AddressedGraphs`` output that is a held tensor comes back as None
    # (the caller's tensor, among ``leaves``)
    got = [None if t is None else t.clone() for t in prog.replay(inputs)]
    torch.cuda.synchronize()
    bad = [i for i, (a, b) in enumerate(zip(got, want))
           if a is not None and not torch.equal(a, b)]
    for j, ((t, pool), w) in enumerate(zip(leaves, want_cache)):
        if not (torch.equal(t[:, 1:], w[:, 1:]) if pool else torch.equal(t, w)):
            bad.append(f"cache leaf {j}")
    restore()
    if bad:
        raise AssertionError(f"graphs {label} {key}: the replay differs from the eager call "
                             f"in outputs {bad}")
    return {"program": "/".join(map(str, key)), "eager_ms": eager_ms, "replay_ms": replay_ms,
            "launches": mode.launches,
            "kernels": {n: c for n, c in prog.launches.items() if c},
            "capture_s": prog.capture_s}


def _graph_engine_checks(label, engine, kinds, checked=None):
    """Every captured program of ``engine`` checked (``_check_graph_program``;
    of the kinds in ``checked`` alone where given: an engine whose other
    programs an earlier engine of the phase checked), the prefill graphs
    counted against ``prefill_compile_count``, and each program kind of
    ``kinds`` captured."""
    got = {key[0] for key in engine._graphs}
    if not set(kinds) <= got:
        raise AssertionError(f"graphs {label}: captured {sorted(engine._graphs)}, "
                             f"missing {sorted(set(kinds) - got)}")
    if engine.prefill_graph_count != engine.prefill_compile_count:
        raise AssertionError(f"graphs {label}: {engine.prefill_graph_count} prefill graphs "
                             f"for prefill_compile_count {engine.prefill_compile_count} "
                             f"({engine.prefill_compile_counts()})")
    rows = [_check_graph_program(label, engine, key, prog)
            for key, prog in sorted(engine._graphs.items(), key=lambda kv: str(kv[0]))
            if checked is None or key[0] in checked]
    pool = engine.graph_pool_bytes()
    log(f"graphs {label}: {len(rows)} programs bit-equal to their eager calls; prefill "
        f"graphs {engine.prefill_graph_count} = prefill_compile_count "
        f"{json.dumps(engine.prefill_compile_counts())}; pool {pool / 1e6:.1f} MB")
    for r in rows:
        log(f"graphs {label} {r['program']}: eager {r['eager_ms']:.3f} ms, replay "
            f"{r['replay_ms']:.3f} ms ({r['eager_ms'] / r['replay_ms']:.1f}x), "
            f"{r['launches']} launches a replay (counted), kernels {json.dumps(r['kernels'])},"
            f" capture {r['capture_s']:.2f}s")
    return rows, pool


def _service_probe_ms(engine, prompt_len, new, seed=28):
    """Phase 28's probe: one ONLINE request on the idle engine, timed after
    an untimed one of the same size."""
    import numpy as np
    import torch

    from repro_torch.serving.core import Priority, SamplingParams

    rng = np.random.default_rng(seed)
    secs = []
    for _ in range(2):
        req = engine.core.submit(rng.integers(0, engine.cfg.vocab_size, prompt_len)
                                 .astype(np.int32), SamplingParams(max_new_tokens=new),
                                 priority=Priority.ONLINE)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        while engine.core.has_unfinished:
            engine.core.step()
        torch.cuda.synchronize()
        secs.append(time.monotonic() - t0)
        if len(req.output_tokens) != new:
            raise AssertionError(f"graphs: the service probe returned {req.output_tokens}")
    return secs[1] * 1e3


def phase_graphs(policies):
    """Phase 36: the engine's serving programs as CUDA graphs, at full depth
    in bf16: qwen3-1.7b on the paged and the dense layout, plain and paired
    with its draft (chunked prefill, the spec loop, the decode loop), with
    monolithic prefill and radix hits (the bucket and suffix prefills, the
    draft's bucket prefill), falcon-mamba-7b and zamba2-2.7b (the bucket
    prefill, the recurrent decode loop).  Each engine serves a round, then
    every graph it captured is held to its eager call (``_check_graph_program``)
    and the prefill graphs to ``prefill_compile_count``; the pool's bytes are
    printed.  The "sample" spec mode draws from the engine's generator,
    registered with its graphs: its stream must equal the eager engine's
    from the same seed.  Last, phase 28's service probe on an eager engine
    and on a graphed one."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.configs import SpecDecodeConfig, draft_config
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import InferenceEngine, Request

    class EagerEngine(_EagerGraphs, InferenceEngine):
        pass

    t_phase = time.monotonic()
    gc.collect()
    torch.cuda.empty_cache()
    cfg = configs.get_config("qwen3-1.7b")
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                           dtype=torch.bfloat16)
    spec = SpecDecodeConfig(proposer="draft", gamma_buckets=(2,))
    dcfg = draft_config(cfg, spec)
    dparams = T.init_params(dcfg, torch.Generator(device="cuda").manual_seed(1),
                            dtype=torch.bfloat16)
    rng = np.random.default_rng(36)
    prompts = _prompts(rng, 8, 24, 136, cfg.vocab_size, shared_prefix=64,
                       shared_idx=(0, 5, 6, 7))
    pools, rows = {}, {}

    def make(cls, layout, draft, cfg_=cfg, params_=params, **kw):
        if draft:
            kw.update(draft_cfg=dcfg, draft_params=dparams, spec=kw.pop("spec", spec))
        return cls(cfg_, params_, max_slots=8, max_seq=512, **layout, **kw)

    for label, layout, draft in GRAPH_QWEN_ENGINES:
        engine = make(InferenceEngine, layout, draft)
        reqs, secs = _serve(engine, prompts, 16)
        _check_finished(f"graphs {label}", reqs, 16, cfg)
        kinds = {"spec" if draft else "decode",
                 "bucket" if layout.get("prefill_chunk") == 0 else "chunk"}
        rows[label], pools[label] = _graph_engine_checks(label, engine, kinds)
        if layout.get("prefill_chunk") == 0 and not engine.prefill_skipped_tokens:
            raise AssertionError(f"graphs {label}: no radix hit (no suffix prefill)")
        del engine
    # the random mode: graphed == eager from the same seed
    sample = SpecDecodeConfig(proposer="draft", gamma_buckets=(2,), mode="sample")
    streams = {}
    for name, cls in (("graphed", InferenceEngine), ("eager", EagerEngine)):
        engine = make(cls, {}, True, spec=sample)
        reqs, _ = _serve(engine, prompts[:4], 16)
        streams[name] = [list(r.output_tokens) for r in reqs]
        if cls is InferenceEngine:
            rows["sample"], pools["sample"] = _graph_engine_checks("paged + draft, sample",
                                                                   engine, {"spec"})
        del engine
    if streams["graphed"] != streams["eager"]:
        raise AssertionError("graphs: the sampled spec stream of the graphed engine differs "
                             "from the eager engine's from the same seed")
    log("graphs: the \"sample\" spec mode through graphs with the engine's generator "
        "registered: streams equal to the eager engine's from the same seed")
    # the host-proposed tree round, one graph per (parents, mode): prompts
    # of a repeating 8-token period, so the n-gram lookup proposes
    periodic = [np.resize(p[:8], len(p)) for p in prompts]
    for label, layout, tspec in (
            ("paged n-gram", {}, SpecDecodeConfig(proposer="ngram")),
            ("dense n-gram, width 2", {"kv_page_size": 0},
             SpecDecodeConfig(proposer="ngram", tree_width=2))):
        engine = make(InferenceEngine, layout, False, spec=tspec)
        reqs, secs = _serve(engine, periodic, 16)
        _check_finished(f"graphs {label}", reqs, 16, cfg)
        rows[label], pools[label] = _graph_engine_checks(label, engine, {"tree", "chunk"},
                                                         checked={"tree"})
        log(f"graphs {label}: {_tree_graphs(label, engine)}; {engine.spec_rounds} tree rounds, "
            f"acceptance {engine.spec_acceptance_rate:.4f}; 8 x 16 tokens in {secs:.3f}s")
        del engine
    # the "simulated" tree stream: graphed == eager from one generator seed
    sim = SpecDecodeConfig(proposer="ngram", mode="simulated")
    streams = {}
    for name, cls in (("graphed", InferenceEngine), ("eager", EagerEngine)):
        engine = make(cls, {}, False, spec=sim)
        reqs, _ = _serve(engine, periodic[:4], 16)
        streams[name] = ([list(r.output_tokens) for r in reqs], engine.spec_rounds,
                         engine.spec_accepted, engine.spec_drafted)
        if cls is InferenceEngine:
            label = "paged n-gram, simulated"
            rows[label], pools[label] = _graph_engine_checks(label, engine, {"tree"},
                                                             checked={"tree"})
            log(f"graphs {label}: {_tree_graphs(label, engine)}")
        del engine
    if streams["graphed"] != streams["eager"]:
        raise AssertionError(f"graphs: the simulated tree stream (streams, rounds, accepted, "
                             f"drafted) of the graphed engine {streams['graphed'][1:]} differs "
                             f"from the eager engine's {streams['eager'][1:]}")
    log(f"graphs: the \"simulated\" tree rounds through graphs with the engine's generator "
        f"registered: streams, rounds, accepted and drafted {streams['graphed'][1:]} equal to "
        f"the eager engine's from the same seed")
    # decode_microstep's single step, graphed and eager over one schedule
    micro = {}
    for name, cls in (("graphed", InferenceEngine), ("eager", EagerEngine)):
        engine = make(cls, {}, False)
        reqs = [Request(prompt=p, max_new_tokens=16) for p in prompts]
        if not all(engine._admit_request(r) for r in reqs):
            raise AssertionError("graphs decode_microstep: an admission failed")
        engine._drive_prefill_chunks()
        times = []
        while engine.num_active:
            torch.cuda.synchronize()
            t0 = time.monotonic()
            engine.decode_microstep()
            torch.cuda.synchronize()
            times.append((time.monotonic() - t0) * 1e3)
        micro[name] = ([list(r.generated) for r in reqs], sorted(times)[len(times) // 2])
        if cls is InferenceEngine:
            label = "paged, decode_microstep"
            rows[label], pools[label] = _graph_engine_checks(label, engine, {"step", "chunk"},
                                                             checked={"step"})
        del engine
    if micro["graphed"][0] != micro["eager"][0]:
        raise AssertionError("graphs: decode_microstep's streams through its graph differ from "
                             "the eager engine's")
    log(f"graphs: decode_microstep (8 slots x 16 tokens) streams equal graphed and eager; a "
        f"call (the step, the fetch, the host's bookkeeping) median "
        f"{micro['graphed'][1]:.3f} ms graphed, {micro['eager'][1]:.3f} ms eager")
    # phase 28's probe, eager and graphed
    probe = {}
    for name, cls in (("eager", EagerEngine), ("graphed", InferenceEngine)):
        probe[name] = _service_probe_ms(make(cls, {}, False), SERVICE_PROMPT, SERVICE_NEW)
    log(f"graphs: phase 28's service probe ({SERVICE_PROMPT} + {SERVICE_NEW} tokens, idle "
        f"qwen3-1.7b engine) eager {probe['eager']:.3f} ms, graphed {probe['graphed']:.3f} ms "
        f"({probe['eager'] / probe['graphed']:.2f}x); the simulator's gate "
        f"{policies['gate_s'] * 1e3:.3f} ms (phase 28, whose own probe, graphed, took "
        f"{policies['service_s'] * 1e3:.3f} ms)")
    del params, dparams
    gc.collect()
    torch.cuda.empty_cache()
    # the recurrent families at full depth
    for arch in ("falcon-mamba-7b", "zamba2-2.7b"):
        rcfg = configs.get_config(arch)
        rparams = T.init_params(rcfg, torch.Generator(device="cuda").manual_seed(0),
                                dtype=torch.bfloat16)
        engine = InferenceEngine(rcfg, rparams, max_slots=8, max_seq=512)
        reqs, _ = _serve(engine, _prompts(rng, 4, 24, 136, rcfg.vocab_size, 0, ()), 8)
        _check_finished(f"graphs {arch}", reqs, 8, rcfg)
        rows[arch], pools[arch] = _graph_engine_checks(arch, engine, {"bucket", "decode"})
        del engine, rparams
        gc.collect()
        torch.cuda.empty_cache()
    log(f"graphs: pools {json.dumps({k: round(v / 1e6, 1) for k, v in pools.items()})} MB; "
        f"phase {time.monotonic() - t_phase:.1f}s")
    return rows


# ---------------------------------------------------------------------------
# 37. train graphs: the train step replayed as one CUDA graph
# ---------------------------------------------------------------------------

#: phase 37's configs: (label, arch, layers (None: full depth), TrainConfig
#: keywords, whether the step's sections are timed); the cut configs at the
#: depths of their own train phases (13, 24), zamba2-2.7b at 3 of its 9
#: cycles and musicgen-large at 12 of 48 layers to keep the run inside its
#: time limit (both run at full depth in phases 17 and 21, eagerly)
TRAIN_GRAPH_CASES = (
    ("qwen3-1.7b", "qwen3-1.7b", None, {}, False),
    ("falcon-mamba-7b", "falcon-mamba-7b", FALCON_TRAIN_LAYERS, {"remat_policy": "full"},
     False),
    ("moonshot-v1-16b-a3b", "moonshot-v1-16b-a3b", 2, {}, False),
    ("zamba2-2.7b", "zamba2-2.7b", 18, {"remat_policy": "full"}, False),
    ("musicgen-large", "musicgen-large", 12, {"remat_policy": "full"}, False),
    ("olmo-1b dots", "olmo-1b", None, {"remat_policy": "dots"}, True),
)
#: steps a run: the eager run, the graphed run (its first call the eager
#: warm-up and the capture, then replays) and the replays after the state
#: is restored in place
TRAIN_GRAPH_STEPS = 3
TRAIN_GRAPH_SEED = 37
#: the olmo-1b Trainer's settings: int8 EF over two microbatches, FSDP and
#: ZeRO-1 on the mesh; steps before the injected failure, after it, and on
#: each layout of the remesh round trip
TRAINER_GRAPH_KW = dict(remat_policy="full", grad_compression="int8_ef", microbatches=2,
                        fsdp=True, zero1=True)
TRAINER_GRAPH_STEPS = 3
#: leaves are fingerprinted in chunks of this many 4-byte words
_FP_CHUNK = 1 << 26


def _fingerprints(tree):
    """Each leaf's bits folded into two wrapping int64 sums, its words
    plain and weighted by position: equal bits give equal sums in any
    summation order, and a changed word changes them.  So a 20-40 GB state
    is compared without a second copy of it."""
    import torch

    from repro_torch.tree import tree_leaves

    words_of = {4: torch.int32, 2: torch.int16, 1: torch.int8}
    out = []
    for t in tree_leaves(tree):
        words = t.detach().reshape(-1).view(words_of[t.element_size()])
        s = torch.zeros(2, dtype=torch.int64, device=t.device)
        for i in range(0, words.numel(), _FP_CHUNK):
            w = words[i:i + _FP_CHUNK].to(torch.int64)
            pos = torch.arange(i + 1, i + 1 + w.numel(), dtype=torch.int64, device=t.device)
            s[0] += w.sum()
            s[1] += (w * pos).sum()
        out.append(s)
    return torch.stack(out).cpu()


class _Sections:
    """The train step's forward (``T.lm_loss``), backward
    (``torch.autograd.grad``), clip and AdamW, each under
    ``torch.profiler.record_function`` and between two CUDA events, while
    active: ``times()`` gives each section's host (launch) and device ms
    over the calls since the last ``times()``."""

    def __init__(self):
        import torch

        from repro_torch.models import transformer as T
        from repro_torch.runtime import step as step_module

        self._at = [(T, "lm_loss", "forward"), (torch.autograd, "grad", "backward"),
                    (step_module, "clip_by_global_norm", "clip"),
                    (step_module, "adamw_update", "adamw")]
        self._saved = []
        self._calls = []

    def __enter__(self):
        import torch

        def wrap(fn, name):
            def call(*a, **kw):
                with torch.profiler.record_function(f"train/{name}"):
                    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                    t0 = time.perf_counter()
                    e0.record()
                    out = fn(*a, **kw)
                    e1.record()
                    self._calls.append((name, time.perf_counter() - t0, e0, e1))
                return out
            return call

        for mod, attr, name in self._at:
            self._saved.append((mod, attr, getattr(mod, attr)))
            setattr(mod, attr, wrap(getattr(mod, attr), name))
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in self._saved:
            setattr(mod, attr, fn)

    def times(self) -> dict:
        import torch

        torch.cuda.synchronize()
        out: dict = {}
        for name, host_s, e0, e1 in self._calls:
            host, dev = out.get(name, (0.0, 0.0))
            out[name] = (host + host_s * 1e3, dev + e0.elapsed_time(e1))
        self._calls = []
        return out


def _allocs() -> int:
    import torch

    return torch.cuda.memory_stats().get("num_device_alloc", 0)


def _sectioned_step(label, fn, state, batch, sections):
    """One call of ``fn`` with its sections timed (``_Sections``): the
    wall ms, device allocations (``cudaMalloc``s) and retries, and each
    section's host / device ms, logged.  Returns ``(metrics, seconds)``."""
    import torch

    retries = torch.cuda.memory_stats().get("num_alloc_retries", 0)
    allocs = _allocs()
    (_, m), secs = _timed(fn, state, batch)
    parts = sections.times()
    log(f"train graphs {label}: {secs * 1e3:.1f} ms wall; cudaMalloc {_allocs() - allocs}, "
        f"allocator retries {torch.cuda.memory_stats().get('num_alloc_retries', 0) - retries}"
        + "".join(f"; {k} host {h:.1f} / device {d:.1f} ms" for k, (h, d) in parts.items()))
    return m, secs


def _train_graph_case(label, arch, layers, kw, sections):
    """Phase 37, one config: its train step (fp32 params + AdamW, bf16
    compute, 4 x 1024 from the seed) counted once by ``launch.cost``
    (kernels priced, not run), then from the seed's state ``TRAIN_GRAPH_STEPS``
    eager steps, the same steps through ``art.jitted()`` (one capture) and,
    after the seed's state is copied back into the live tensors (the
    ``Trainer``'s restore), the same again on the same graph.  The losses,
    gradient norms and every state leaf (``_fingerprints``) must be
    bit-equal to the eager run's; where they are not, a second eager run
    gives the gap between two eager runs, which the graphed runs must stay
    within.  Returns the row printed in phase 37's table."""
    import torch

    from repro_torch import configs
    from repro_torch.configs import TrainConfig
    from repro_torch.data import SyntheticDataset
    from repro_torch.kernels import ops
    from repro_torch.launch.cost import CountingMode
    from repro_torch.models import transformer as T
    from repro_torch.runtime import init_train_state, make_train_step
    from repro_torch.tree import tree_leaves

    _fresh_phase()
    cfg = configs.get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    tcfg = TrainConfig(warmup_steps=2, total_steps=TRAIN_GRAPH_STEPS + 8, **kw)
    state = init_train_state(T.init_params(cfg, torch.Generator(device="cuda").manual_seed(
        TRAIN_GRAPH_SEED)), tcfg)
    # the seed's weights on the host: a restore takes no device memory beside
    # the graph's pool
    seed = [t.detach().cpu() for t in tree_leaves(state["params"])]
    state_gb = sum(t.numel() * t.element_size() for t in tree_leaves(state)) / 1e9
    ds = SyntheticDataset(cfg, seq_len=TRAIN_S, global_batch=TRAIN_B, seed=TRAIN_GRAPH_SEED)
    batches = [{k: torch.as_tensor(v, device="cuda") for k, v in ds.next_batch().items()}
               for _ in range(TRAIN_GRAPH_STEPS)]
    art = make_train_step(cfg, tcfg)

    @torch.no_grad()
    def restore():
        """The seed's state copied into the live tensors (the Trainer's
        restore)."""
        for live, new in zip(tree_leaves(state["params"]), seed):
            live.copy_(new)
        for t in tree_leaves({k: v for k, v in state.items() if k != "params"}):
            t.zero_()

    def run(fn, sec=None):
        metrics, secs = [], []
        for i, b in enumerate(batches):
            if sec is None:
                (_, m), dt = _timed(fn, state, b)
            else:
                m, dt = _sectioned_step(f"{label} eager step {i}", fn, state, b, sec)
            metrics.append(torch.stack([m["loss"], m["grad_norm"]]).double().cpu())
            secs.append(dt)
        return torch.stack(metrics), secs, _fingerprints(state)

    # the launches of one step, counted (its kernels priced, not run: the
    # state it leaves is garbage, and restored)
    with CountingMode() as mode:
        art(state, batches[0])
    counted = mode.launches
    restore()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    if sections:  # where an eager step's time goes, the first one too
        with _Sections() as sec:
            eager = run(art, sec)
    else:
        eager = run(art)
    eager_peak = torch.cuda.max_memory_allocated() / 1e9
    eager_reserved = torch.cuda.max_memory_reserved() / 1e9
    restore()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    graphed = art.jitted()
    ops.reset_launch_counts()
    first = run(graphed)
    first_peak = torch.cuda.max_memory_allocated() / 1e9
    first_reserved = torch.cuda.max_memory_reserved() / 1e9
    restore()
    again = run(graphed)
    counts = ops.launch_counts()
    graphs = graphed.graphs
    if (graphs.captures, len(graphs.graphs)) != (1, 1):
        raise AssertionError(f"train graphs {label}: {graphs.captures} captures, "
                             f"{len(graphs.graphs)} live graphs (one state: one each)")
    graph, = graphs.graphs.values()
    pool, capture_s = graphs.pool_bytes() / 1e9, graph.prog.capture_s
    # what a replaying step holds: the live tensors and the graph's pool (a
    # replay allocates nothing, so the allocator's peak does not show it)
    held_gb = torch.cuda.memory_allocated() / 1e9 + pool
    kernels = {n: c for n, c in graph.prog.launches.items() if c}
    if not kernels:
        raise AssertionError(f"train graphs {label}: the graph launches no hand-written kernel")
    _require_launches(f"train graphs {label}", counts, tuple(kernels))
    runs = {"graphed": first, "after restore": again}
    exact = all(torch.equal(r[0], eager[0]) and torch.equal(r[2], eager[2])
                for r in runs.values())
    gap = None
    if not exact:
        # two eager runs from the same state: the graphed runs within their gap
        del graph, graphs, graphed
        gc.collect()
        torch.cuda.empty_cache()
        restore()
        twin = run(art)
        rel = lambda a, b: ((a - b).abs() / b.abs()).max(dim=0).values
        gap = rel(twin[0], eager[0])
        worst = {name: rel(r[0], eager[0]) for name, r in runs.items()}
        apart = bool((gap > 0).any()) or not torch.equal(twin[2], eager[2])
        if not (apart and all(bool((w <= gap).all()) for w in worst.values())):
            raise AssertionError(
                f"train graphs {label}: relative loss / grad norm differences from the eager "
                f"run {json.dumps({k: w.tolist() for k, w in worst.items()})} outside the gap "
                f"between two eager runs {gap.tolist()}")
        log(f"train graphs {label}: two eager runs differ (relative loss / grad norm gap "
            f"{gap.tolist()}, states bit-equal {torch.equal(twin[2], eager[2])}); the graphed "
            f"runs within it: " + json.dumps({k: w.tolist() for k, w in worst.items()}))
    med = lambda xs: sorted(xs)[len(xs) // 2] * 1e3
    replay_s = first[1][1:] + again[1]
    row = {"config": label, "depth": cfg.num_layers, "remat": tcfg.remat_policy,
           "eager_ms": med(eager[1]), "replay_ms": med(replay_s),
           "first_call_ms": first[1][0] * 1e3, "capture_s": capture_s,
           "launches": counted, "kernels": kernels, "pool_gb": pool,
           "state_gb": state_gb, "eager_peak_gb": eager_peak, "first_peak_gb": first_peak,
           "eager_reserved_gb": eager_reserved, "first_reserved_gb": first_reserved,
           "held_gb": held_gb, "bit_equal": exact,
           "gap": None if gap is None else gap.tolist()}
    log(f"train graphs {label} ({_card()}; {cfg.num_layers} layers, remat {tcfg.remat_policy}, "
        f"fp32 + AdamW, B={TRAIN_B} x S={TRAIN_S}): {TRAIN_GRAPH_STEPS} steps eager, graphed "
        f"and graphed again after the state's restore: losses "
        + ", ".join(f"{x:.6f}" for x in eager[0][:, 0].tolist())
        + f"; losses, grad norms and all {len(eager[2])} state leaves bit-equal {exact}; one "
        f"capture; eager ms " + ", ".join(f"{t * 1e3:.1f}" for t in eager[1])
        + "; graphed ms " + ", ".join(f"{t * 1e3:.1f}" for t in first[1] + again[1])
        + f" (the first: eager warm-up + capture); launches a replay {counted} (counted), "
        f"hand-written {json.dumps(kernels)}; pool {pool:.2f} GB; state {state_gb:.2f} GB; "
        f"held while replaying (allocated + pool) {held_gb:.2f} GB; peak allocated eager "
        f"{eager_peak:.2f} GB, graphed run (warm-up and capture) {first_peak:.2f} GB; peak "
        f"reserved eager {eager_reserved:.2f} GB, graphed run {first_reserved:.2f} GB")
    if sections and exact:
        # eager steps beside the live graph, then a replay (one launch: no
        # section runs in it), timed between two events
        with _Sections() as sec:
            for i in range(2):
                _sectioned_step(f"{label} eager step {i} after the capture", art, state,
                                batches[i], sec)
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            _, secs = _sectioned_step(f"{label} replayed step", graphed, state, batches[2], sec)
            e1.record()
            torch.cuda.synchronize()
            log(f"train graphs {label} replayed step: {secs * 1e3:.1f} ms wall, device "
                f"{e0.elapsed_time(e1):.1f} ms between events around the call")
    del state, batches, art, seed
    return row, {n: c["cuda"] for n, c in counts.items()}


def _trainer_graphs(mesh):
    """Phase 37, the ``Trainer``: olmo-1b at ``OLMO_CYCLE_LAYERS`` layers,
    full width, ``TRAINER_GRAPH_KW`` (int8 EF over two microbatches, remat
    "full", FSDP + ZeRO-1 on a mesh), its step ``art.jitted()``, against a
    twin whose step is the eager ``art``: ``TRAINER_GRAPH_STEPS`` steps, a
    failure injected at the next (no checkpoint: the seed's state copied
    back in place, ``Trainer._restart``) and as many steps again, then
    ``remesh`` onto ``mesh`` (one NCCL rank), steps, ``remesh(None)``,
    steps.  The losses bit-equal to the twin's at every step and the
    states at the end; one capture per state; the live graphs one; device
    memory allocated equal before and after the round trip."""
    import torch

    from repro_torch import configs
    from repro_torch.configs import TrainConfig
    from repro_torch.runtime import Trainer

    _fresh_phase()
    cfg = dataclasses.replace(configs.get_config("olmo-1b"), num_layers=OLMO_CYCLE_LAYERS)
    tcfg = TrainConfig(warmup_steps=2, total_steps=8 * TRAINER_GRAPH_STEPS, **TRAINER_GRAPH_KW)
    kw = dict(seq_len=TRAIN_S, global_batch=TRAIN_B)
    twin, trainer = Trainer(cfg, tcfg, **kw), Trainer(cfg, tcfg, **kw)
    twin.step_fn = twin.art
    fired = []

    def fail_once(step_no):
        if step_no == TRAINER_GRAPH_STEPS and not fired:
            fired.append(step_no)
            return True
        return False

    trainer.fail_hook = fail_once
    ours, ref = trainer.train(2 * TRAINER_GRAPH_STEPS), twin.train(2 * TRAINER_GRAPH_STEPS)
    # the restart replays steps 0 .. TRAINER_GRAPH_STEPS - 1 on the same graph
    want = ref.losses[:TRAINER_GRAPH_STEPS] + ref.losses
    if fired != [TRAINER_GRAPH_STEPS] or ours.restores != 1 or ours.losses != want:
        raise AssertionError(f"trainer graphs: losses {ours.losses} against the eager "
                             f"{want} (restores {ours.restores})")
    graphs = trainer.step_fn.graphs
    if (graphs.captures, len(graphs.graphs)) != (1, 1):
        raise AssertionError(f"trainer graphs: {graphs.captures} captures before the remesh")
    del graphs
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    steps = {"none": list(ours.step_times_s)}
    for label, target in (("mesh", mesh), ("none again", None)):
        for t in (trainer, twin):
            t.remesh(target)
        twin.step_fn = twin.art
        n0 = len(trainer.report.losses)
        trainer.train(TRAINER_GRAPH_STEPS)
        twin.train(TRAINER_GRAPH_STEPS)
        if trainer.report.losses[n0:] != twin.report.losses[-TRAINER_GRAPH_STEPS:]:
            raise AssertionError(f"trainer graphs on {label}: losses "
                                 f"{trainer.report.losses[n0:]} against the eager "
                                 f"{twin.report.losses[-TRAINER_GRAPH_STEPS:]}")
        graphs = trainer.step_fn.graphs
        if (graphs.captures, len(graphs.graphs)) != (1, 1):
            raise AssertionError(f"trainer graphs on {label}: {graphs.captures} captures, "
                                 f"{len(graphs.graphs)} live graphs")
        steps[label] = trainer.report.step_times_s[n0:]
        del graphs
    gc.collect()
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    if not torch.equal(_fingerprints(trainer.state), _fingerprints(twin.state)):
        raise AssertionError("trainer graphs: the state after the round trip differs from "
                             "the eager twin's")
    # a graph that kept its state alive would leave a whole state behind
    # (~4 GB here); a few incidental blocks (a collective's) may differ
    if abs(after - before) > FLAT_BYTES:
        raise AssertionError(f"trainer graphs: device memory allocated {before} before the "
                             f"remesh round trip, {after} after")
    log(f"trainer graphs ({_card()}; olmo-1b at {cfg.num_layers} of 16 layers, full width, "
        f"int8_ef, 2 microbatches, remat full, FSDP + ZeRO-1 on the mesh, B={TRAIN_B} x "
        f"S={TRAIN_S}): the Trainer's jitted() step bit-equal to the eager twin's over "
        f"{TRAINER_GRAPH_STEPS} steps, a failure and restart ({ours.restores} restore), "
        f"{TRAINER_GRAPH_STEPS} more, then remesh none -> {mesh.shape} -> none, "
        f"{TRAINER_GRAPH_STEPS} steps on each (losses " + ", ".join(
            f"{x:.6f}" for x in trainer.report.losses) + "); one capture per state; device "
        f"memory allocated {before} bytes before the round trip, {after} after; step ms " + "; ".join(
            f"{k} " + ", ".join(f"{t * 1e3:.1f}" for t in v) for k, v in steps.items())
        + f" (the first on a state: eager warm-up + capture); pool "
        f"{trainer.step_fn.graphs.pool_bytes() / 1e9:.3f} GB")
    del trainer, twin
    _end_phase("trainer graphs")


def phase_train_graphs():
    """Phase 37: the train step replayed as one CUDA graph
    (``TrainStepArtifacts.jitted``), each of ``TRAIN_GRAPH_CASES`` against
    its eager step (``_train_graph_case``), then the ``Trainer``
    (``_trainer_graphs``) over a one-rank NCCL mesh.  Prints the table of
    eager and replay ms, launches a replay, capture s, pool and peaks.
    Returns the graphed runs' launch counts, summed."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_dev_mesh

    t_phase = time.monotonic()
    rows, total = [], {}
    for case in TRAIN_GRAPH_CASES:
        t0 = time.monotonic()
        row, counts = _train_graph_case(*case)
        for n, c in counts.items():
            total[n] = total.get(n, 0) + c
        rows.append(row)
        _end_phase(f"train graphs {case[0]}")
        log(f"train graphs {case[0]}: {time.monotonic() - t0:.1f}s")
    store = tempfile.mkdtemp(prefix="train_graphs_")
    dist.init_process_group("nccl", init_method=f"file://{store}/store", rank=0, world_size=1)
    try:
        _trainer_graphs(make_dev_mesh(device="cuda"))
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    log(f"train graphs table ({_card()}): " + json.dumps(rows))
    for r in rows:
        capture = "—" if r["capture_s"] is None else f"{r['capture_s']:.2f}"
        log(f"train graphs | {r['config']} ({r['depth']} layers, {r['remat']}) | eager "
            f"{r['eager_ms']:.1f} ms | replay {r['replay_ms']:.1f} ms | "
            f"{r['eager_ms'] / r['replay_ms']:.2f}x | {r['launches']} launches | capture "
            f"{capture} s | pool {r['pool_gb']:.2f} GB | held replaying {r['held_gb']:.2f} GB, "
            f"peak reserved {r['first_reserved_gb']:.2f} GB graphed / "
            f"{r['eager_reserved_gb']:.2f} GB eager (allocated {r['eager_peak_gb']:.2f}) | "
            f"bit-equal {r['bit_equal']}")
    log(f"train graphs: phase {time.monotonic() - t_phase:.1f}s")
    return total


def main() -> int:
    try:
        import torch  # noqa: F401
    except ImportError:
        raise SystemExit("[smoke] FAIL: torch is not installed")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    try:
        import repro_torch  # noqa: F401
    except ImportError:
        raise SystemExit(
            "[smoke] FAIL: src/repro_torch not found beside chip_smoke.py "
            "(run it from a checkout of the repository)"
        )
    t_start = time.monotonic()
    phase_device()
    rows = phase_kernels(phase_build())
    phase_parity()
    launches, colloc = phase_collocated()
    phase_chaos(colloc)  # before any profiler session, as phase 5
    policies = phase_policies(colloc)  # phase 28, over phase 5's measured profile
    del colloc
    # phases 11-14 before phase 7's first profiler session: after one, every
    # launch costs more on the host
    phase_moe_parity()
    moe_launches, moe_spec_launches = phase_moe_serve()
    slice_launches = {"moe_serve": moe_launches, "moe_spec_serve": moe_spec_launches,
                      "moe_train": phase_moe_train(), **phase_config_serves()}
    # phases 15-17, zamba2-2.7b, also before any profiler session
    phase_hybrid_parity()
    hybrid_launches = {"hybrid_serve": phase_hybrid_serve(),
                       "hybrid_train": phase_hybrid_train()}
    # phases 18-21, musicgen-large and pixtral-12b, also before any profiler
    # session
    phase_audio_vlm_parity()
    av_launches = {**phase_musicgen_serve(), **phase_pixtral_serve(),
                   **phase_audio_vlm_train()}
    slice_launches.update({run: av_launches[run]
                           for run in ("pixtral_serve", "pixtral_dense", "pixtral_train")})
    # phases 22-24, Mamba1 training and recurrent speculation, also before any
    # profiler session
    rec_launches = phase_falcon_train()
    phase_recurrent_spec_parity()
    rec_launches.update(phase_recurrent_spec_serve())
    slice_launches.update(rec_launches)
    # phases 25-27, olmo-1b and the training entry point, also before any
    # profiler session
    phase_olmo_parity()
    t_serve = time.monotonic()
    olmo_launches = phase_config_serves(OLMO_SERVES)
    log(f"olmo serve: {time.monotonic() - t_serve:.1f}s")
    olmo_launches.update(phase_olmo_train())
    slice_launches.update(olmo_launches)
    # phase 29, the online example at olmo-1b's full width, also before any
    # profiler session
    slice_launches["online_serving"] = phase_online_serving()
    # phases 30-31, the sharded train step over NCCL and the fused collocated
    # step, and phases 32-34, the model axis' kernels at each rank's shapes,
    # the serve steps on the mesh and Mamba1 / the hybrid over the model
    # axis, also before any profiler session
    scale_launches, model_axis_rows = phase_scale_out()
    slice_launches.update(scale_launches)
    row_runs = {**av_launches, **olmo_launches}
    # phase 36, the serving programs' graphs against their eager calls, also
    # before any profiler session
    phase_graphs(policies)
    # phase 37, the train step replayed as one CUDA graph, also before any
    # profiler session
    slice_launches["train_graphs"] = phase_train_graphs()
    serve_launches = phase_serve()
    spec_launches = phase_spec_serve()
    dense_launches = phase_dense_target_serve()
    ssm_launches = phase_ssm_serve()
    # the end-of-run profiler sessions, phase 35's first
    phase_cost_model()
    _profile_moe_serve()
    _profile_hybrid_serve()
    _profile_train()
    _profile_train("zamba2-2.7b", "hybrid train", "full")
    _flash_bwd_by_kernel(next(r for r in rows if r["name"] == "flash_attention_bwd"))
    _ssm_bwd_by_kernel(next(r for r in rows if r["name"] == "ssm_scan_bwd"))
    _verify_by_kernel(rows)
    _decode_by_kernel(rows)
    for row in rows:
        # each kernel's launches on the run of its path: the hd-80 rows in
        # the hybrid runs (the train run's for flash, the serve run's for the
        # decode), the spec kernels in the spec serve run, the dense verify /
        # tree verify in the dense target serve run, the scan in the ssm serve
        # run, the others in the collocated run
        if row["name"].endswith("_hd80"):
            name = row["name"][: -len("_hd80")]
            serve, train = (hybrid_launches[r][name] for r in ("hybrid_serve", "hybrid_train"))
            row["launches"] = train if name.startswith("flash") else serve
            row["launches_hybrid_serve"], row["launches_hybrid_train"] = serve, train
            continue
        # the audio / VLM and olmo slices' rows: the first of their runs that
        # launched them (flash in the musicgen train run, #1 / #2 in the serve
        # runs, #7 / #9 in musicgen's spec serve run, #3 in pixtral's dense
        # run)
        suffix = next((s for s in SLICE_ROW_RUNS if row["name"].endswith(s)), None)
        if suffix is not None:
            name = row["name"][: -len(suffix)]
            runs = {r: row_runs[r].get(name, 0) for r in SLICE_ROW_RUNS[suffix]}
            row["launches"] = next((n for n in runs.values() if n), 0)
            row.update({f"launches_{r}": n for r, n in runs.items() if n})
            continue
        if row["name"] in FP8_ROWS:
            row["launches"] = slice_launches["serve_steps_fp8"][row["name"]]
        elif row["name"] in SPEC_KERNELS:
            row["launches"] = spec_launches[row["name"]]
            if row["name"] in ("prefill_attention", "decode_attention"):
                row["launches_dense_target"] = dense_launches[row["name"]]
        elif row["name"] in ("verify_attention", "tree_verify_attention"):
            row["launches"] = dense_launches[row["name"]]
        elif row["name"] in SSM_KERNELS:
            row["launches"] = ssm_launches[row["name"]]
        elif row["name"] == "ssm_scan_bwd":
            row["launches"] = rec_launches["falcon_train"][row["name"]]
        else:
            row["launches"] = launches[row["name"]]
            if serve_launches[row["name"]]:
                row["launches_serve"] = serve_launches[row["name"]]
        # and its launches in the MoE and other configs' runs that use it
        for run, counts in slice_launches.items():
            if counts.get(row["name"]):
                row[f"launches_{run}"] = counts[row["name"]]
    # phases 32's and 34's rows: their launches are their stand-in serve
    # runs'
    rows.extend(model_axis_rows)
    idle = [row["name"] for row in rows if not row["launches"] > 0]
    if idle:
        raise AssertionError(f"kernels with no launch on their path: {idle}")
    log(f"all phases passed in {time.monotonic() - t_start:.1f}s")
    print(json.dumps({"kernels": rows}), flush=True)
    import torch

    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
