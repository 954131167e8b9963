#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA H100 and check it.

    python3 chip_smoke.py

Phases, each printing JSON lines (any failure raises, so the script exits
non-zero and never prints the final line):

1. device: the card's name and power limit (``nvidia-smi``);
2. build: ``nvcc`` builds every kernel under ``perceiver_io_tpu_torch/csrc``
   and the phase prints ``ptxas``' registers and spills per kernel;
3. kernel: the flash attention forward (K1) against its plain PyTorch
   version at the serving path's shapes (b = 4, 8 heads, head dim 112:
   cross-attention i = 512 over j = 1024 with left-pad dead rows, the latent
   stack at j = 512, the q_len = 1 decode attend, ragged tiles i = 100 over
   j = 612, a decode attend whose lengths leave whole key splits masked
   and one row dead, and a speculative verify's cross and stack attends at
   b = 20 (4 slots x 5 lanes, each lane its own pad: per-row stack pads of
   up to 508 latent slots, whose rows below the first live latent are
   dead); every case but the ragged and verify ones again at head dims 64,
   96, 128 and 32, timed over fewer iterations; and at the symbolic-audio
   model's GiantMIDI shapes at head dim 96: the cross attend of 2048 latents
   over 6144 keys (b = 2, one row's pads reaching 104 rows into the
   latents), the 2048 x 2048 latent stack and a decode attend over up to
   6144 keys); then non-causal: clm-base's cross attend (one batch row
   all padded: dead rows) and stack at d = 112, and the masked LM's three
   attends at language-perceiver width with v of its own head dim (the
   encoder's cross attend of 256 latents over 2048 right-padded tokens at
   (d, dv) = (32, 160), one row all pad; its 256 x 256 self-attends at (32,
   160); the decoder's 2048 queries over 256 latents at (32, 96)) and a
   split case at (32, 160); then the classifiers' attends
   (``K1_CLASSIFIER_CASES``): the text classifier at the JAX CLI's defaults,
   (160, 160) on the tile routes (its encoder cross attend, 256 x 2048 with
   one row all padded, a 256 x 256 self-attend and its decoder's one query
   over 256 latents on ``split``), and the ``wide_mma`` route at the image
   classifier's widths (its encoder cross attend, b = 2, one head of (261,
   261), 512 latents over 50176 pixels; its decoder's query over 512 latents
   at (1024, 1024); MNIST's 32 x 784 at (131, 131) with pads and a dead
   batch row; a causal 100 x 300 at (131, 131), right-aligned, with pads,
   dead rows and a dead batch row) and at its design's edges (i = 16 and 17
   at (261, 261) around its 16-row tiles; (64, 1024) and (300, 40), where
   its warps split the output's columns; (261, 261) with q, k and v one
   element off a 16-byte boundary), and at optical flow's attends at
   b = 1 (``K1_FLOW_CASES``: the encoder's cross attend of 2048 latents
   over 182528 pixels at (322, 322) and the decoder's 182528 per-pixel
   queries over 2048 latents at (512, 512), both on ``wide_mma``'s column
   split, and a 16-head 2048 x 2048 self-attend at (32, 32); bf16 gated at
   the smaller of 2e-2 and 8 ulps, no ``prev_ms``); fp32 and bf16, through the route the
   wrapper picks (``wide_mma`` for a pair outside ``HEAD_DIMS``, ``split``
   for decode, ``wgmma`` for bf16 tiles, ``tf32x3`` for fp32 tiles; a wrong
   route fails), held at fp32 1e-4, bf16 2e-2 (at the pairs outside
   ``HEAD_DIMS`` the smaller of that and 8 bf16 ulps of the reference's
   largest ``|o|``) and lse 1e-3 on live rows, dead rows exactly 0 with
   ``lse`` the mask value. The earlier design runs on the same inputs, is
   held to the same gates and is timed beside it (``prev_ms``: the first
   CUDA-core kernel (simt), which does not instantiate head dims 96, 32 and
   160, whose cases carry ``prev_ms`` null; at the pairs outside
   ``HEAD_DIMS`` the first ``wide`` design, reached by name), with the plain
   version's time, ``scaled_dot_product_attention``'s with its backend
   pinned to memory-efficient attention, or to its math backend where that
   one refuses the head dims (261 and 131; ``library_backend`` names the one
   timed; a yardstick the port never calls) and the card's bound (here and
   in phase 12 its bytes count k and v only for the keys some query row
   sees, as K4's count only live keys; for
   ``tf32x3`` and ``wide_mma`` cases ``bound_ms`` at a third of the TF32
   tensor-core rate and ``bound_simt_ms`` at the CUDA cores' rate, as in
   phase 12). Then each of
   the split, wgmma and tf32x3 routes must refuse a query on a base off a
   16-byte boundary (``ValueError``, no launch counted). Every timed loop
   here and in phases 6 and 12 reads the next of enough input copies to fill
   the L2 twice, so its times are HBM times, as the bound is, and queues
   behind a sleep kernel, so they are the card's times without the host's
   dispatch (``device_ms``); the refusals run at head dims 112 and 96;
4. model: the full-width C4 CLM ("clm-base": vocab 32000, 1024 context, 512
   latents, 896 channels, 8 heads, 16 layers; random weights from a seed),
   one forward with the kernel against ``attention_impl="xla"``, fp32 and
   bf16 compute; the same forward with ``PERCEIVER_FUSED_QKV=1`` (q/k/v in
   one product a self-attention layer, k/v in one at the cross-attention)
   against the unfused one, within the same gates, with equal K1 launches
   and 103 -> 70 GEMM calls (aten ``mm``/``addmm``/``bmm``), both forwards'
   ms; a bf16 greedy ``generate()`` (4 prompts of 480 tokens, 64 latents,
   32 new tokens) fused and unfused, run unfused, fused, fused, unfused,
   tokens equal under the near-tie rule, ms a step of each run; and a small
   model's greedy tokens on the card against the same model on the CPU;
5. serve: ``ServingEngine.serve()`` over the full-width model (fp32): 8
   ragged requests in two configs that together run prefill, latent growth,
   prefix growth and the sliding window; served tokens must equal
   per-request ``generate()``; K1 must run its split and tf32x3 routes and
   never simt;
6. k4: the ragged paged-attention kernel (K4) against its plain PyTorch
   version at clm-base's shapes (8 heads, head dim 112, block size 16, 64
   pages a row): a decode case (8 rows, q_len 1, lengths 0..1023, tail
   pages unmapped, trash in the null block), the same rows at q_len 7 (two
   shorter than 7, their first queries dead), a window case (8 rows, q_len
   512, lengths 520..1024), ragged query tiles (8 rows, q_len 100, one row
   idle and one of 40 keys, whose first 60 queries see nothing), the
   slot engine's window step (4 rows, q_len 512, lengths 520..1024, one
   idle), a shared finalize's attend (4 rows, q_len 512, lengths
   520..1000, tables aliasing the same 24 leading pages; the bound counts
   those pages once) and one finalize as the slot engine calls it (1 row,
   q_len 512, length 1000); the decode and window cases again at head dims
   64, 96 and 128, timed over fewer iterations; and at the GiantMIDI shapes
   at head dim 96 over 384-page tables: decode rows (b = 4, lengths up to
   6143) and window rows of 2048 latents (lengths 2100..6144); and K4 per
   shard (phase 14c): a rank's 2 slot rows at 4 heads of 112 (clm-base over
   ``model=2``), decode (lengths 1023, 700) and window (q_len 512,
   lengths 1024, 777). Each in
   fp32, bf16 and int8 with scales, through
   the route the wrapper picks (``split`` for decode rows, ``tc`` for
   window rows; a wrong route fails), held at 4e-3 in bf16 and 1e-4
   otherwise, idle rows and dead queries exactly 0, every output finite.
   The first CUDA-core kernel (simt) runs on the same inputs, is held to
   the same gates and is timed beside it (``prev_ms``; null at head dim
   96, which it does not instantiate). With the plain
   version's time, the gather reference plus
   ``scaled_dot_product_attention`` (``gather_sdpa_ms``, a yardstick the
   port never calls) and the card's bound (window cases: fp32 and int8 at a
   third of the TF32 tensor-core rate, bf16 at the bf16 rate, and
   ``bound_simt_ms`` at the CUDA cores' rate). No single PyTorch call reads
   a block table, so ``library_ms`` is null. Then the split and tc routes
   must each refuse a query and a pool on a base off a 16-byte boundary
   (``ValueError``, no launch counted), at head dims 112 and 96;
7. slot serve: ``SlotServingEngine`` over the full-width model (fp32), 4
   slots, 12 requests with 496 latents, prompts of 500..960 tokens and
   ``max_new_tokens`` cycling 16/32/48, once per KV layout (dense, paged,
   paged_int8): rows admit into recycled slots mid-flight and cross into the
   boundary phase at different steps. Dense and paged tokens must equal
   per-request ``generate()`` (a divergence is excused only at a near-tie:
   the reference's top-2 logit gap at the first divergent token < 1e-4); K4
   must run under the paged layouts, its decode rows on ``split`` and its
   window rows on ``tc``, never on simt, and not under dense, K1's fp32 tiles on
   ``tf32x3`` and never on ``simt``; the pool must end empty and leak-free. The int8 run's agreement with the paged run is
   printed, not gated;
8. slot prefix: ``SlotServingEngine`` with chunked
   prefill (``prefill_chunk=128``), 4 slots, 12 requests with 496 latents,
   over clm-base's widths at ``SHALLOW_SERVE_LAYERS`` (4) of its 16 layers
   since PR 24 (phases 8-11 share that model, a cut of depth; their gates
   hold the same at any depth):
   one shared 384-token system prompt (24 pages of 16) then each request's
   own suffix, to the slot-serve phase's prompt lengths (longest first,
   ``max_new_tokens`` cycling 16/32/48), once per KV layout: dense
   (chunking only), paged and paged_int8 (with ``prefix_cache="on"``). The
   first admission misses and is chunked through the staging caches (K1
   finalize); the later ones hit (full 24-page hits, and partial-block
   copy-on-write hits where a request's own prefix region ends inside the
   system prompt) and finalize through K4 ``tc`` over the pool. Gates: every
   request completes, chunks ran, dense and paged tokens equal per-request
   ``generate()`` (the near-tie excuse as in phase 7), under the paged
   layouts prefix hits >= 1 and hits + misses = 12, K4's ``tc`` launches
   exceed the boundary steps by at least the hits, K1 and K4 never on simt,
   and the pool leak-free with ``in_use`` equal to the prefix index's cached
   blocks, 0 after its flush. Printed: TTFT and admission-to-first-token p50
   of hits and of misses, hit ratio, shared tokens, COW copies, ``tc``
   launches per shared finalize, the int8 run's agreement with the paged
   run and with an int8 run without sharing, and, from a second run of each
   layout without ``prefill_chunk``, the residents' largest inter-token ms
   during the 960-token admission with and without chunking;
9. slot preempt: ``SlotServingEngine`` over phase 8's model (fp32) with a
   pool of 160 blocks, five eighths of the dense 4 x 64, lazy admission on
   prompt pages alone (``admit_headroom_blocks=0``), and phase 7's 12
   requests: every third interactive (``priority=1``), the rest batch (0),
   tenants alternating ``a`` and ``b``; the batch requests arrive first and
   the interactive ones 8 decode steps later, while batch residents hold the
   pool, so a higher tier's head preempts at admission and residents
   crossing a block boundary preempt at decode. Runs: ``paged`` under
   ``recompute``, ``swap`` and ``auto``, ``paged_int8`` under ``swap``, and
   ``paged`` under ``swap`` over phase 8's shared-system-prompt requests with
   ``prefill_chunk=128`` and ``prefix_cache="on"``. Gates, each run: every
   request completes; paged tokens equal phases 7's and 8's ``generate()``
   references (the near-tie excuse as in phase 7); at least one preemption
   and one readmission; under ``swap`` at least one swap, every swap
   restored and none left waiting; the pool leak-free with ``in_use`` 0 (in
   the shared run equal to the prefix index's cached blocks, 0 after its
   flush); K4 on ``split`` and ``tc`` only, K1 never on ``simt``. Printed:
   preemptions at admission and at decode, readmissions, victims by tier and
   tenant, swaps and swap bytes, each direction's ms p50 and measured GB/s,
   the post-mortem totals (``recompute_est_ms``, ``swap_est_ms``,
   ``swap_measured_ms``) and the victims ``auto`` swapped, each swapped
   victim's payload bytes against the pool bytes the cost model prices,
   TTFT p50 per tier, tokens/s and the peak residents against phase 7's
   paged run, and the int8 run's agreement with the fp32 ``generate()``
   references;
10. slot spec: speculative decoding and the measured ``auto`` axes over
   phase 7's requests at clm-base's widths over ``SHALLOW_SERVE_LAYERS``
   (4) of its 16 layers (fp32, random weights from the same seed; a cut
   of depth since PR 24, with their ``generate()`` references computed
   first; every gate below follows the depth, the tokens/s of phase 7
   printed beside are its full depth's). (a)
   ``speculative_generate`` on phase 7's first 4 requests with a
   full-depth draft, ``SpecConfig(4, 4)``: tokens equal ``generate()``
   (the near-tie excuse as in phase 7) and every drafted token accepted
   but at a near-tie (the verify lane's top logit less the draft's <
   1e-4; the draft runs at b rows and the verify at b·(k+1)), counted;
   then ``SpecConfig(4, 2)``: tokens equal, acceptance printed. (b)
   ``SlotServingEngine`` with 4 slots: ``speculation="k4d2"`` paged over
   the first 6 requests (a round reads no KV cache: one layout),
   ``"k2d1"`` paged with ``preemption="swap"`` over phase 9's 160-block
   pool and all 12 requests, and one bf16 ``k4d2`` paged run over the 6. Gates (fp32 runs): tokens equal phase 7's
   references (near-tie excuse), emitted = served tokens, accepted <=
   proposed, every verify call at 4·(k+1) rows and one a round, K1 at
   k·(1+d) + 1 + layers launches a round, every K1 tile on ``tf32x3`` (bf16:
   ``wgmma``) and none on simt, K4 on split/tc only and never inside a
   round, every swap restored, the pool leak-free. Printed: tokens/s
   beside phase 7's, rounds, acceptance, K1 launches and device ms a round
   (CUDA events around each round), preemptions and swaps, and the bf16
   run's agreement with its fp32 twin (not gated). (c) A fresh registry
   file, an engine with ``decode_strategy``, ``kv_layout``,
   ``prefix_cache`` and ``speculation`` all ``"auto"`` and its
   ``warmup()``: each verdict with its timings; each probe's fence held
   (one of its arms timed again between synchronisations, the median of
   three runs, the probe's figure within 2x of it); a second engine over
   the file measures
   nothing (no probe engine built, no ``generate`` call);
11. sample: sampled decoding and beam search over phase 10's shallow
   model (fp32; since PR 24), phase 7's requests and that model's
   references and phase 5's workload. (a) The sampler on the
   card against its plain CPU path: ``(4, 32000)`` logits of 4 of phase 7's
   prompts and a seeded numpy Gumbel table fed through
   ``samplers.gumbel_noise``; temperature 0.7, top-k 50, top-p 0.9,
   repetition penalty 1.2 and their combination: filtered logits equal (a
   top-p keep-set difference excused within 1e-6 of p) and tokens
   identical; the sampler's device ms a step. (b) ``do_sample=True,
   top_k=1`` equals greedy: the bucket engine over phase 5's workload
   against a greedy run of it, the slot engine dense and paged against
   phase 7's references (the near-tie excuse of phase 7). (c) Temperature
   0.8, top-k 50, top-p 0.95 through the bucket engine, then the slot
   engine dense and paged over phase 7's first 6 requests, each run with seed A, seed A again
   and seed B: every request completes, seed A twice identical, A and B
   differ, 4 requests' tokens inside their step's top-k ∩ nucleus of a
   teacher-forced ``_decode_forward`` (slack 1e-4 on the logit), K1's fp32 tiles on
   ``tf32x3`` and K4 on ``split``/``tc``, never simt, the pool leak-free;
   printed beside the greedy tokens/s (phase 7's, or this phase's greedy
   bucket run). (d) Beam search: ``beam_search(num_beams=1)`` over 2 of
   phase 5's prompts equals ``generate()`` (near-tie excuse); ``generate(
   num_beams=4, max_new_tokens=16, min_new_tokens=16)`` on 2 prompts runs
   exactly 1 + layers K1 calls a step (1 cross + the stack's attends), all
   ``tf32x3``, with its ms a step and a bf16 twin's agreement (printed);
   a small model's beam tokens on the card equal the same weights' on the
   CPU. (e) ``TextGenerationPipeline`` over clm-base's widths with the
   byte tokenizer's 262-token vocabulary: ``bucketing=True`` gives the
   text ``bucketing=False`` gives, and a beam call returns text;
11b. obs: telemetry over phase 7's requests at ``SHALLOW_SERVE_LAYERS``
   (4) of the 16 layers (fp32): three of its requests
   (``OBS_REQUESTS``) through the paged slot engine (4 slots,
   ``OBS_KV_BLOCKS`` blocks, ``recompute`` preemption), first with no
   attachment, then with every one (a registry, a tracer streaming
   ``events.jsonl``, a step timeline, a flight recorder, an SLO monitor,
   a profiler trigger). (a) Tokens equal the unobserved run's and phase
   7's references (the near-tie excuse); K1's and K4's launches by route
   equal the unobserved run's; no bundle, every terminal span ``ok``. (b)
   The trigger armed before decode step ``OBS_ARM_STEP`` runs the next
   decode step under ``torch.profiler``; its Chrome trace
   (``build/chip_smoke_obs/observed/profile/regress-step<N>/trace.json``)
   must exist and name one of K1's and one of K4's kernels, read from
   ``csrc/``. (c) Two steps later ``hbm_bytes_in_use`` equals
   ``torch.cuda.memory_allocated()`` read at that point, and
   ``kv_cache_resident_bytes`` the pool's tensor bytes (mapped blocks'
   k, v and scales, and the stack caches). (d) A ``kv.exhaust`` fault at
   decode step ``OBS_EXHAUST_STEP`` preempts a victim whose readmission
   waits: one ``pool_exhausted`` bundle, which ``obs incident`` renders.
   (e) The build ledger holds one ``kernel_build`` record per source this
   process built (``_build.BUILD_LOG``). (f) Decode-step ms p50 with and
   without the attachments, A B B A (printed, not gated);
11c. fleet: outer serving over phase 7's requests at clm-base's widths and
   ``SHALLOW_SERVE_LAYERS`` (4) of its layers (fp32): 8 of its
   requests (``FLEET_REQUESTS``: prompts 500-960, 496 latents, 16/32/48
   new tokens) through ``FleetRouter`` over two paged slot replicas of 4
   slots. (a) No fault: tokens equal phase 7's ``generate()`` references
   (the near-tie excuse), beside one engine of 8 slots (tokens/s of both
   printed). (b) ``crash_replica(0, FLEET_CRASH_STEP)`` mid-decode: every
   request ``ok``, tokens equal (a)'s under the same rule,
   ``fleet_failover_total`` >= 1, one restart, no pool holds a page, and
   ``torch.cuda.memory_allocated()`` after ``gc.collect()`` within 1 % of
   its value just before the crash (the crashed engine's pool and state are
   freed). (c) ``remove_replica`` mid-flight: its pages return tagged
   ``scale_down``, tokens equal (a)'s, memory falls at the removal and
   returns within 1 % after ``add_replica``, and again after a
   ``restart``. (d) A replica evacuated mid-flight by ``remove_replica``
   is resized 4 -> 6 -> 4 (``resize_slots``) and serves the 4 requests it
   lost, tokens equal (a)'s. (e) ``StreamingGateway`` over a fleet on
   ``127.0.0.1:0``: 4 concurrent SSE streams through ``GatewayHttpClient``
   with tokens equal (a)'s, a fifth cut by ``disconnect_stream`` before
   its third token (the fleet request ``cancelled``, its pages freed, no
   slot left active), ``/healthz`` 200 and ``/metrics`` naming every
   ``gateway_*`` counter family; the p50 of ``gateway_socket_ttft_ms`` and
   ``serving_ttft_ms`` printed. K1 on ``split`` / ``tf32x3`` and K4 on
   ``split`` / ``tc`` in every run, ``simt`` never, the gateway's runs
   launching from its event loop's thread;
12. k23: the flash-attention backward kernels, K2 (dq) and K3 (dk, dv),
   against their plain versions at the training path's shapes (b = 4, 8
   heads, head dim 112; the cross attends over j = 768, 256 kept prefix +
   512 latents, and j = 1024, with left pads that leave dead rows; the
   latent stack at j = 512 with no pad mask, also at head dims 64, 96, 128
   and 32; ragged tiles i = 100 over j = 300 with pads; and at head dim 96 the
   symbolic-audio model's training cross attend, i = 2048 over j = 4096
   (2048 kept prefix under prefix dropout 0.5 and 2048 latents, left pads
   reaching 452 rows into the latents), and its 2048 x 2048 stack; then
   non-causal, phase 3's clm-base cross attend over j = 768 with a batch
   row all padded and the masked LM's three attends at (d, dv) = (32, 160)
   and (32, 96); then ``K23_CLASSIFIER_CASES``: the text classifier's
   encoder cross and self-attend at (160, 160), and on ``wide_mma`` the
   image classifier's training attends, its encoder cross attend (b = 2, (261,
   261), 512 x 50176), its decoder's query (b = 8, (1024, 1024), 1 x 512)
   and MNIST's (131, 131) cross attend with a dead batch row, and a causal
   100 x 300 case at (131, 131) with pads and dead rows; the bounds count
   4d + 2dv flops a visible pair for K2 and 4d + 4dv for K3), fp32
   and bf16, through the
   route the wrappers pick (``wide_mma`` outside ``HEAD_DIMS``, else ``wgmma``
   for bf16, ``tf32x3`` for fp32; a wrong route fails), held at
   ``max|d| <= tol * max|plain|`` per output,
   tol 1e-4 in fp32 and 2^-7 (two bf16 ulps) in bf16, where each bf16
   output's error against the fp32 plain backward of the same inputs must
   also stay within 1.5x the plain bf16 version's; dead rows' dq and unseen
   keys' dk/dv must be exactly 0 and every output finite. With each
   kernel's time, the earlier design's on the same inputs (``prev_ms``: the
   ``simt`` kernels, the CUDA-core design both types took first, null at
   head dim 96, which they do not instantiate; at the pairs outside
   ``HEAD_DIMS`` the first ``wide`` design, reached by name), the plain
   version's, the backward alone of ``scaled_dot_product_attention`` (its
   memory-efficient backend pinned, its math backend where that one refuses;
   a yardstick the port never calls) and the card's bound (in fp32
   ``bound_ms`` at a third of the TF32 tensor-core rate, the most the
   ``tf32x3`` and ``wide_mma`` routes' three products per fp32 product can
   reach, and ``bound_simt_ms`` at the CUDA cores' rate, as the simt
   route's rows). The ``simt`` kernels' outputs are held to 1e-4 of each
   output's largest plain entry in both types, ``wide``'s to the gates of
   the route beside it (``prev_rel_err``, ``prev_oracle_ratio``), with the
   same zeros and finite values, before they are timed;
13. train, over the full-width CLM:
   (a) one loss + backward with the kernels against ``attention_impl="xla"``
       (batch 4 x 1024, left pads inside the prefix, one prefix-dropout
       seed). fp32: loss within 1e-5 relative, every parameter's gradient
       present, finite and within ``1e-3 * max|g_ref|``. bf16 compute over
       the same parameters: each gradient, against the fp32 ``xla`` one,
       within 1.5x the bf16 ``xla`` path's own error plus one bf16 ulp of
       its largest entry; 17 launches each of K1, K2 and K3, every
       K1/K2/K3 launch on ``tf32x3`` in fp32 and on ``wgmma`` in bf16;
   (b) ``Trainer.fit``, fp32: 8 steps of 8 rows in 2 microbatches, AdamW
       at 1e-4 with ``cosine_with_warmup`` (2 warmup steps), clipping at
       1.0, prefix dropout 0.5, two seeded batches cycled, one validation
       pass: finite losses, the last below the first; 34 launches of each of
       K1, K2 and K3 per optimizer step (17 attends x 2 microbatches;
       validation's launches counted apart, none of K2/K3 there), every
       K1/K2/K3 launch on ``tf32x3``; the best checkpoint reloads into an equal
       model. Prints step ms p50 (three more synchronised steps), loss
       tokens/s and peak memory;
   (c) the same fit in bf16 compute: finite, falling losses, every
       K1/K2/K3 launch on ``wgmma``;
   (d) a small model whose pads reach into the latent window, one SGD step
       on the card against the same weights on the CPU with
       ``attention_impl="flash"`` (the plain forward and backward, same
       dead-row semantics): gradients and updated params within 1e-4;
   (e) a gradient request to K4 raises;
14. train_resilience, over the full-width CLM from the same seeded weights
   and batches (fp32 unless named; every sub-run prints ``step_ms``,
   ``max_memory_allocated`` where it gates memory, and launches by route).
   Before phase 13 and before this phase a garbage collection frees what
   earlier phases left in reference cycles, and ``memory_before_training``
   / ``memory_before_train_resilience`` print the bytes still allocated
   and the largest live CUDA tensors:
   (a) one optimizer step's gradients (8 rows, 2 microbatches) in fp32 and
       bf16, each in three modes over one model, batch and generator:
       plain, ``activation_checkpointing`` and checkpointing with
       ``activation_offloading``. Loss and gradients equal across the modes
       (fp32 within 1e-3 of each parameter's largest entry and the loss
       within 1e-5; bf16 within 2 bf16 ulps of the largest entry); each
       mode timed over three steps after a warm one (p50); K1
       34 / 68 / 68 per step (the recompute runs every attend's forward
       again), K2 and K3 34, all on ``tf32x3`` in fp32 and ``wgmma`` in
       bf16; peak memory above the sub-run's start (``peak_above_start``,
       printed beside the absolute peak) plain > checkpointing >=
       offloading; the bytes the
       offload hook moved to pinned host memory equal the layer inputs'
       (17 of 4 x 512 x 896 and the kept prefix, per microbatch);
   (b) ``Trainer.fit`` with attention and residual dropout 0.1: the loss
       falls; no K1/K2/K3 launch in the training steps (a train-mode attend
       with dropout takes the plain path, JAX's dispatch), 17 K1 launches in
       the validation pass; one step's gradients with and without
       checkpointing under one generator within the fp32 gate;
   (b)-(g) over clm-base's widths at ``RESILIENCE_SNAPSHOT_LAYERS`` of
   its 16 layers (a cut of depth: (c) and (d)'s snapshots' writes were
   the phase's longest part; since PR 24 (b), (e), (f) and (g) too, the
   launch gates following the depth);
   (c) resume: an uninterrupted 8-step fit with snapshots every 4 steps; a
       fit into a fresh root whose loss function raises SIGTERM at the
       process during step 5 (it finishes the step, snapshots, returns); a
       third trainer with ``resume=`` finishes. The stitched losses equal
       the uninterrupted run's bit for bit;
   (d) recovery under a ``ChaosRegistry`` over 6 steps: ``skip`` with one
       NaN loss at step 3 skips 1 step and ends finite at step 5;
       ``rollback`` with three NaNs in a row from step 3 (snapshots every 2)
       rolls back once, to step 2, and replays to step 6;
   (e) ``steps_per_execution=4``: each block's logged loss equals the mean
       of the same four single steps' losses and the parameters end equal;
       ms per step of both;
   (f) LAMB at 5e-3 (cosine, 2 warmup steps), 8 steps: the loss falls; one
       more update on the card equals the same update on CPU copies of the
       parameters, gradients and moments within 1e-5 of each tensor's
       largest entry;
   (g) ``save_pretrained`` of (f)'s model and ``pipeline_from_pretrained``
       on the card over a token-id tokenizer: the text equals the direct
       pipeline's; with bf16 compute and ``params_dtype=torch.bfloat16`` it
       equals a direct bf16 model's, and K1 takes ``wgmma`` (no ``tf32x3``);
14b. mesh: training parallelism over ``torch.distributed`` at clm-base
   (fp32, AdamW, the train phase's 8 x 1024 batch in 2 microbatches,
   prefix dropout 0.5 from the step generators, ``MESH_STEPS`` steps a
   mesh). (a) One spawned rank (``python3 chip_smoke.py --mesh-rank``),
   NCCL on ``cuda:0``: the no-mesh step (the single-rank trajectory, 34
   K1/K2/K3 launches a step on ``tf32x3``) with AdamW and with LAMB, then
   the mesh ``data=1``, whose losses and parameters equal the AdamW
   trajectory to the bit. (b) Two spawned ranks share
   ``cuda:0`` over gloo (NCCL refuses two ranks on one device; the backend
   is an argument, never a caught failure) with the compute on the card:
   ``data=2``, ``fsdp=2``, ``model=2`` (4 heads of 112 a rank through
   K1-K3), ``data=1, seq=2`` with ``shard_seq`` and
   ``attention_impl="ring"``, and LAMB under ``fsdp=2`` and ``model=2``
   (its trust ratios' whole norms: one all-reduce a step of the shards'
   squared norms); rank 0's losses within 2e-4 of the single-rank
   trajectory of its optimizer (both ranks report the global loss), every rank's
   K1/K2/K3 launches a step 34 each on ``tf32x3`` (0 under ``seq``: every
   attend takes the ring), each mesh's collectives present (``data``: one
   all-reduce of every gradient byte; ``fsdp``: all-gathers and as many
   reduce-scatters; ``model``: all-reduces; ``seq``: ring exchanges, staged
   through host memory on gloo; LAMB: one all-reduce a step more than the
   AdamW case of its mesh, ``norm_all_reduces_per_step``). Printed per mesh and rank: launches by
   route a step, collective calls and bytes by kind a step, step ms p50
   and peak ``max_memory_allocated``, beside the card's ``nvidia-smi``
   line. The ranks load the kernels phase 2 built and refuse to build
   one; a rank that fails fails the phase;
14c. shard: sharded serving (``serving/sharding.py``) at clm-base, fp32:
   6 prompts of 520-990 tokens over 4 slots (two admit mid-flight), 504
   latents, 16 new tokens (8 latent-growth, then boundary steps: K4's
   window rows). (a) In 14b's NCCL world of one, before its training
   cases: per layout (dense, paged) the unsharded engine and
   ``ServingMeshSpec(1, 1)``'s: tokens equal, the final state equal byte
   for byte (the pool's null block apart: scratch that no read uses,
   written by scatters whose duplicate indices may race on the card; a
   second run of the unsharded engine prints its own null-block and leaf
   differences beside the mesh's), K1/K4 launches by route equal. (b) Four ranks
   (``python3 chip_smoke.py --shard-rank``, started beside 14b's worlds)
   share ``cuda:0`` over gloo, a 2x2 mesh at full depth, rank 0 driving:
   per layout tokens equal (a)'s single-rank tokens (the near-tie excuse),
   boundary steps ran, every rank's K1 on split/tf32x3 only and K4
   (paged) on split and tc, none on simt (dense: no K4); every data
   replica of the pool byte-equal (``shard_digests``); after the paged run
   3 requests, 3 steps, a cancel and an evacuation leave the pool with
   nothing in use, reserved or leaked. Printed per rank: K1/K4 launches
   by route, decode steps, step ms p50 (each decode op between two
   synchronises), collective calls and bytes a decode step by kind, peak
   memory, plans. (c) In the same world two 1x2 paged replicas
   (``MeshGroupAllocator``; the driver outside the second group) serve 4
   prompts, 8 new tokens, at ``SHALLOW_SERVE_LAYERS`` layers, replica 0
   crashing on its ``SHARD_CRASH_STEP``-th step: every request ``ok``,
   tokens equal the driver's single-rank engine's (the near-tie excuse),
   one restart, the rebuild on the crashed group, the groups disjoint, no
   pool leaked; K1 and K4 split on every rank. The K4 phase's
   ``K4_SHARD_CASES`` hold K4 at h = 4 (clm-base over ``model=2``);
15. symbolic: the symbolic-audio model at GiantMIDI width (6144 context,
   2048 latents, 768 channels over 8 heads: head dim 96, 12 layers, the
   389-event vocabulary; random weights from a seed; its parameter count
   printed). (a) One forward at b = 2 over 6144 event ids, fp32 and bf16,
   the kernels against ``attention_impl="xla"`` at phase 4's gates. (b)-(e)
   run at ``SYMBOLIC_LAYERS`` (4) of the 12 layers since PR 24 (a cut of
   depth; their launch gates follow it: 2 x 5 a step in (e)). (b)
   Phase 5's two configs scaled to this context through the bucket engine
   (buckets 3072 and 6120, batch 4): 4 prompts of 384-2880 ids with 64
   latents and 4 of 3120-5400 with 2032 (16 latent-growth, 8 boundary and
   8 sliding-window steps, as phase 5's 496 of 512), 32 new tokens each,
   fp32: served tokens equal per-request ``generate()``, K1 on ``split``
   and ``tf32x3`` only. (c) Phase 7's traffic scaled: 8 requests of
   3000-5760 ids, 2032 latents, ``max_new_tokens`` 16/32, 4 slots, buckets
   (3072, 4608, 6048), dense, paged and paged_int8: phase 7's gates (tokens
   equal ``generate()`` with the near-tie excuse, boundary steps run, K4
   on ``split`` and ``tc`` under paged and never ``simt``, K1 on ``split``
   and ``tf32x3``, the pool leak-free; int8 printed, not gated). (d) The
   ``symbolic-audio-generation`` pipeline: greedy over (b)'s prompts equals
   ``generate()``; sampled (temperature 1.0, top-k 15, a
   ``torch.Generator``) ids lie in the vocabulary (how many are the pad id
   is printed: random weights rank it like any event), ``notes_from_events``
   decodes them, a seed repeats and another differs; beam search with 2
   beams over one prompt. (e) ``Trainer.fit``: 8 optimizer steps of 8 rows
   x 6144 ids in 2 microbatches from ``SyntheticSymbolicAudioDataModule``
   (``min_seq_len`` 4096, as ``examples/training/sam.sh``), AdamW to 2e-4
   (cosine, 4 warmup steps), prefix dropout 0.5, in bf16 and fp32: the loss falls, K1, K2 and K3 10
   launches a step each (2 microbatches x 5 attends), all on ``wgmma`` in
   bf16 and ``tf32x3`` in fp32; step ms p50 and peak
   ``max_memory_allocated`` printed;
16. cli: the port's CLI through the functions ``python -m`` calls
   (``perceiver_io_tpu_torch.scripts.text.clm.main`` and
   ``...audio.symbolic.main``), each line with the card's ``nvidia-smi``
   line. (a) ``fit --data=synthetic`` at clm-base width (1024 context, 512
   latents, 896 channels, 8 heads) over ``SHALLOW_SERVE_LAYERS`` (4) of its
   16 layers (the byte tokenizer's 262-id
   vocabulary through the family's link), the family's bf16, 8 steps of 8
   x 1024 in 2 microbatches, AdamW to 2e-5 (cosine, 2 warmup steps; 1e-4
   overshot on this corpus),
   clipping at 1, one validation batch, the best checkpoint written: the
   loss is finite and falls, K1, K2 and K3 launch 10 times a step on
   ``wgmma`` (validation's K1 counted apart), and phase 13's ``train_fit``
   driving ``Trainer.fit`` directly with the same arguments logs the same
   losses within 1e-6 relative. (b) ``validate --ckpt`` and ``test --ckpt``
   on that checkpoint: a finite loss each. (c) ``serve --ckpt`` (fp32) over
   a prompts file of 8 ragged byte prompts of 520-960 characters and one
   of 1010 (past the largest bucket: an error record), 496 latents, 32 new
   tokens (latent growth, boundary and window steps): the bucket engine
   (buckets 512/1000, batch 4), then the slot engine (4 slots, buckets
   512/768/1008, ``kv_layout=paged``); tokens equal per-request
   ``generate()`` on the card from the same checkpoint (the slot engine
   under phase 7's near-tie excuse), completions equal the decoded
   references, K1 on ``split`` and ``tf32x3`` in both runs, K4 on
   ``split`` and ``tc`` in the slots run, ``simt`` never, and the
   ``serve_stats`` line parses; the slots run again with
   ``--serve.replicas=2 --serve.autoscale.max=3`` (the fleet and its
   autoscaler), whose lines must equal the single engine's; then the bucket
   run's first batch (its first 4 prompts) once more as a real
   ``python -m perceiver_io_tpu_torch.scripts.text.clm serve`` process,
   whose JSON lines must equal the in-process run's for them. (d) The symbolic
   family's ``fit --data=synthetic`` at GiantMIDI width (6144 context,
   ``min_seq_len`` 4096, the family's 2048 latents and 768 channels, 8
   heads of 96) over ``SYMBOLIC_LAYERS`` (4) layers, bf16, 4 steps of 8
   rows in 2 microbatches (AdamW to phase 15's 2e-4, 4 warmup steps): a
   finite loss, K1, K2 and K3 10 launches a step on ``wgmma``. The fit of
   (a) runs with ``--obs.events_path``, ``--obs.snapshot_every_s`` and
   ``--obs.profile_on_regress_factor`` (``CLI_FIT_OBS``): one fenced
   ``trainer.step`` span a step under one trace, and a snapshot counting
   8 steps; the slots ``serve`` of (c) with ``--obs.events_path``,
   ``--obs.timeline.*`` and ``--obs.snapshot_path``: every line carries a
   ``trace_id``, and ``obs report`` and ``obs timeline`` render over what
   it wrote;
17. mlm: the masked LM at language-perceiver width (vocab 262, 2048
   context, d_model 768, 256 latents of 1280 channels, 26 self-attends, 8
   heads over qk 256 with v 1280 in the encoder and 768 in the decoder,
   tied embeddings, no decoder attention residual; random weights,
   201,108,230 parameters). (a) One forward of 4 rows at n = 2048 and at
   n = 1500 with right pads, fp32 and bf16, against ``attention_impl="xla"``
   at phase 15's gates; 28 K1 launches a forward (1 cross + 26 self + 1
   decoder), all ``tf32x3`` in fp32 and ``wgmma`` in bf16. (b)
   ``pipeline("fill-mask")`` over 8 byte texts of 512-2048 bytes with 6
   masked words each, top-5, fp32: the fillings equal the ``xla`` run's (a
   difference excused only where a masked position's top-6 logits hold a
   gap below 1e-4), texts/s and latency p50. (c) The MLM CLI's ``fit``
   (bf16, 8 steps of 8 x 2048 in 2 microbatches over the synthetic corpus
   with word masking, the published widths as flags, AdamW to phase 16's
   2e-5): falling losses, K1/K2/K3 56 launches a step on ``wgmma``, and
   phase 13's ``train_fit`` with the same arguments gives the same losses
   bit for bit (its step ms and peak memory); then ``validate`` / ``test
   --ckpt``, 28 K1 launches each;
18. classifiers: the text classifier at language-perceiver width (the
   ``mlm`` phase's encoder; the CLI's decoder, one query of 1280 channels
   over 8 heads, 2 classes; 206,098,690 parameters) and the Fourier image
   classifier at deepmind/vision-perceiver-fourier width (224 x 224 x 3, 64
   bands, 512 x 1024 latents, one cross head, 8 blocks x 6 shared
   self-attends of 8 heads, 1000 classes; 48,440,627 parameters, the
   reference's), random weights from a seed; every parameter count gated
   equal to the JAX package's. (a) One text forward of 4 rows at n = 2048
   and 1500 with right pads, fp32 and bf16, against ``xla`` (fp32 1e-3,
   bf16 8 ulps of the largest logit), 28 K1 launches a forward (27 on the
   type's tile route, the decoder's query on ``split``); and one at the JAX
   CLI's defaults, (160, 160) in every attend (10 launches). (b)
   ``pipeline("sentiment-analysis")`` over 8 byte texts of 512-2048 bytes:
   labels equal the ``xla`` run's but where a text's own two ``xla`` logits
   lie within ``NEAR_TIE``; texts/s and latency p50. (c) The classifier
   CLI's two-stage ``fit`` in bf16, 8 steps of 8 x 2048 in 2
   microbatches over the synthetic corpus's classification task, AdamW to
   1e-4: stage 1 warm-starts the encoder from a masked LM of the same widths
   saved by the port (``--model.encoder.params``) and freezes it: its loss
   falls and its encoder ends bit-identical to the loaded one; stage 2
   starts from stage 1's checkpoint (``--params``) unfrozen and moves the
   encoder; 56 K1/K2/K3 launches a step in each (K1 54 ``wgmma`` + 2
   ``split``), step ms p50 (the trainer's ``steps_per_sec``), peak memory,
   whether the frozen stage computes encoder gradients (its K2/K3 at every
   attend); then ``validate`` / ``test --ckpt`` (loss and accuracy;
   ``validate`` reproduces stage 2's validation loss). (d) One
   image forward at b = 4, fp32 and bf16, against ``xla``: 50 K1 launches,
   the encoder's cross attend and the decoder's query on ``wide_mma``, 48 on the
   tile route; ``pipeline("image-classification")`` top-5 over 8 seeded
   uint8 images of 256 x 320 through ``ImageNetPreprocessor``: top-1 equals
   ``xla``'s but at an image whose own top-2 ``xla`` logits lie within
   ``NEAR_TIE``, images/s and latency p50; a bf16 ``Trainer.fit`` of 8 steps
   of 8 synthetic images in 2 microbatches through phase 13's ``train_fit``:
   the loss falls, 100 K1/K2/K3 launches a step, 4 of them at the wide
   pairs (K1, K2 and K3 on ``wide_mma``). (e) The image CLI at
   MNIST's shape (28 x 28 x 1, 32 x 128 latents, 32 bands, JAX's MNIST
   test's one cross head: q/k 131 on K1, K2 and K3 ``wide_mma``;
   the 16-wide heads elsewhere take the plain path), fp32: ``fit`` over the
   synthetic image data module, 2 K1/K2/K3 launches a step, all at (131,
   131), finite losses
   (8 steps hardly move this model's); ``validate`` / ``test --ckpt``,
   ``validate`` reproducing the fit's validation loss;
19. flow: optical flow at deepmind/optical-flow-perceiver width (its
   transformers config as ``FLOW_HF``, through the port's
   ``optical_flow_config_from_hf``: 368 x 496 patches, 64 hidden channels
   and 64 Fourier bands, d_model 322, 2048 x 512 latents, 24 self-attends
   of 16 heads of 32, one cross head at (322, 322), the decoder's one head
   at (512, 512) without a residual; random weights, 41,057,134 parameters,
   the JAX package's). (a) One forward of 2 seeded synthetic frame pairs
   (``(2, 2, 27, 368, 496)``), fp32 and bf16, against ``xla`` (fp32 1e-3 of
   the largest |flow|, bf16 8 ulps of it); (b) 26 K1 launches a forward:
   both cross attends on ``wide_mma``, the 24 self-attends on the type's
   tile route; (c) forward ms p50, images/s and peak
   ``max_memory_allocated``; (d) ``pipeline("optical-flow")`` over 2 seeded
   uint8 frame pairs of Sintel's 436 x 1024 (6 patches a pair, micro-batches
   of 2), fp32: the flow equals the same model's run patch by patch (b =
   1) through ``OpticalFlowProcessor`` within 1e-5, K1 26 launches a
   micro-batch, pairs/s and the per-pair latency p50; (e) the pipeline once
   with ``render=True``: uint8 RGB frames of the pairs' shape;
20. the ``{"kernels": [...]}`` summary line (K1 with the four routes the
   main path runs nested, the simt kernel's times as their ``prev_ms``, an
   entry for each of K2's and K3's routes that the main path runs, K4 with
   its split and tc routes nested and the simt kernel's times as their
   ``prev_ms``; K1's and K4's ``launches`` count their wrappers' calls and
   their ``kernel_launches`` the device kernels, two per split-route call;
   K4's ``slot_prefix_launches`` the paged slot-prefix run's calls and
   ``slot_preempt_launches`` each slot-preempt run's; K1's and K4's
   ``slot_spec_launches`` each slot-spec engine run's and
   ``sample_launches`` each sampled run's and ``obs_launches`` phase 11b's
   observed run's and ``fleet_launches`` each of phase 11c's runs; K1's
   ``beam_launches`` the
   counted beam run's; K1's, K2's and K3's ``train_resilience_launches``
   each phase-14 sub-run's, over its three timed steps in (a); each route's
   ``d96`` figures (its GiantMIDI case at head dim 96) and
   ``symbolic_launches`` (its calls in each run of phase 15); every
   entry's ``cli_launches`` and ``cli_route_launches`` its calls in each
   run of phase 16, ``mlm_launches`` in each run of phase 17 and
   ``classifiers_launches`` in each run of phase 18 and ``flow_launches``
   in each run of phase 19; each route's
   ``head_dims``, the (d, dv) pairs its cases ran; the entries at the wide
   pairs (K1, K2 and K3 ``wide_mma`` with the first ``wide`` design's
   times as their ``prev_ms``, and K1-K3 ``wide`` itself, reached by name
   only, ``launches`` 0; K1's nested in its ``routes``) take ``launches``
   from phase 18's bf16 image fit),
   the card's
   ``nvidia-smi`` line, and the final
   ``{"ok": true, ...}`` line.

Every JSON line carries ``at_s``, the wall seconds since the script
started; each phase ends with a ``phase_seconds`` line of its wall
seconds, and one before the summary lists them all with the total.

fp32 comparisons run with TF32 off (``torch.backends.cuda.matmul.allow_tf32``
and ``torch.backends.cudnn.allow_tf32`` set False).
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # tensor bf16; fp32 outside the tensor cores
TF32_FLOPS = 494.7e12  # dense TF32 on the tensor cores: 3xTF32 spends three of these per fp32 flop
KERNEL_TOL = {"float32": 1e-4, "bfloat16": 2e-2, "int8": 1e-4}
# K4's outputs are ~0.04..0.3 (q.k of unit scale over 300..1023 keys): its
# bf16 limit is 4x the largest error the H100 run gave (9.77e-4), not K1's
K4_TOL = {**KERNEL_TOL, "bfloat16": 4e-3}
# K2/K3: max|kernel - plain| over max|plain|, per output. fp32 takes the
# tf32x3 route: three TF32 products per fp32 product, ~2^-21 relative each
# (a CPU emulation of its arithmetic lands within 1.1e-6 of the Pallas
# kernels, tests/test_torch_port_bwd_routes.py), held at 1e-4. bf16 takes the
# wgmma route: the tensor cores sum in another order, so a p or ds entry
# rounded to bf16 before its product, or an output, can land on the
# neighbouring bf16 value; it is held to two bf16 ulps (2^-7) of each
# output's largest plain entry
K23_REL_TOL = {"float32": 1e-4, "bfloat16": 2.0**-7}
# and, so that the looser bf16 gate cannot hide a defect, each bf16 output's
# max abs error against the fp32 plain backward of the same bf16-valued
# inputs (the oracle) may be at most this factor times the plain bf16
# version's own error against it
K23_ORACLE_RATIO = 1.5
K23_ROUTE = {"float32": "tf32x3", "bfloat16": "wgmma"}
# K2/K3's route for the (d, dv) pairs outside HEAD_DIMS, both types, and
# the earlier design there, reached by name and timed beside it as prev_ms
# under the same gates
K23_WIDE_ROUTE = "wide_mma"
K23_WIDE_PREV = "wide"
# K1's route at those pairs, both types and any query length, and the
# earlier design there, reached by name and timed beside it as prev_ms under
# the same gates
K1_WIDE_ROUTE = "wide_mma"
K1_WIDE_PREV = "wide"
# the simt K2/K3 kernels, timed beside each route as prev_ms, are held to
# 1e-4 in both types, the bar they had when they were the routes
SIMT_REL_TOL = 1e-4
# K2/K3's cases: (name, i, j, left pads per batch row or None, head dim), b = 4
K23_CASES = (
    ("cross", 512, 768, [0, 100, 300, 600], 112),   # 256 kept prefix + 512 latents; row 3's rows 0..343 dead
    ("cross", 512, 1024, [0, 100, 600, 900], 112),  # the whole prefix; row 3's rows 0..387 dead
    ("stack", 512, 512, None, 112),                 # the latent stack: no pad mask, as on the main path
    ("ragged", 100, 300, [0, 30, 150, 260], 112),   # ragged q and kv tiles; row 3's rows 0..59 dead
    ("stack", 512, 512, None, 64),                  # the kernels' other head dims
    ("stack", 512, 512, None, 32),
    ("stack", 512, 512, None, 96),
    ("stack", 512, 512, None, 128),
    # the symbolic-audio model at GiantMIDI width (6144 context, 2048 latents,
    # 768 channels over 8 heads: d = 96): the training cross attend (2048
    # kept prefix under prefix dropout 0.5 + 2048 latents; row 3's pads reach
    # 452 rows into the latents) and the latent stack
    ("cross_sam", 2048, 4096, [0, 500, 1500, 2500], 96),
    ("stack_sam", 2048, 2048, None, 96),
)
# K2/K3's non-causal cases: (name, i, j, left pads, visible keys, d, dv), as
# K1_NONCAUSAL_CASES: clm-base's cross attend with row 3 all padded (dead
# rows, and keys no row sees), then the masked LM's three attends
K23_NONCAUSAL_CASES = (
    ("cross_nc", 512, 768, [0, 100, 300, 768], None, 112, 112),
    ("mlm_enc_cross", 256, 2048, None, [2048, 1500, 700, 0], 32, 160),
    ("mlm_self", 256, 256, None, None, 32, 160),
    ("mlm_dec_cross", 2048, 256, None, None, 32, 96),
)
# K2/K3 at this slice's widths, K1_CLASSIFIER_CASES' shapes with their
# batch: (name, i, j, left pads, visible keys, d, dv, causal, b, h). The
# text classifier at the JAX CLI's defaults (160, 160) on the tile routes;
# the image classifier's training attends on wide_mma: its encoder cross attend
# (b = 2 of the fit's 8 rows; one head of 261 over 50176 pixels), its
# decoder's one query over 512 latents (1024) and MNIST's cross attend
# (131); and wide_mma's causal masking at an odd head dim
K23_CLASSIFIER_CASES = (
    ("clf_enc_cross", 256, 2048, None, [2048, 1500, 700, 0], 160, 160, False, 4, 8),
    ("clf_self", 256, 256, None, None, 160, 160, False, 4, 8),
    ("img_cross", 512, 50176, None, None, 261, 261, False, 2, 1),
    ("img_dec_cross", 1, 512, None, None, 1024, 1024, False, 8, 1),
    ("mnist_cross", 32, 784, None, [784, 784, 500, 0], 131, 131, False, 4, 1),
    ("wide_causal", 100, 300, [0, 30, 260, 300], None, 131, 131, True, 4, 2),
)
# the head dim of the symbolic-audio (GiantMIDI) cases; the simt kernels do
# not instantiate it, so those cases carry no prev_ms
SAM_HEAD_DIM = 96
# timed iterations of the GiantMIDI cases: (kernel, plain version)
SAM_ITERS = (10, 2)
L2_BYTES = 50 * 2**20  # H100 SXM
# the slot-serve phase's prompt buckets: (512, 768, 1024) would make prompts
# past 768 infeasible with 496 latents (a 1024 bucket leaves 528 prefix slots
# > max_prefix_len 512), so the top bucket is 1008 = 512 + 496
SLOT_BUCKETS = (512, 768, 1008)
NEAR_TIE = 1e-4
TRAIN_STEPS = 8


T_START = time.perf_counter()
#: wall seconds of each phase of ``main`` (``timed``), in the order run
PHASE_SECONDS = {}


def emit(phase: str, **fields) -> None:
    """One JSON line of ``phase``, with ``at_s``, the wall seconds since the
    script started."""
    print(json.dumps({"phase": phase, **fields, "at_s": round(time.perf_counter() - T_START, 3)}), flush=True)


def timed(name: str, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, its wall seconds kept in ``PHASE_SECONDS``
    and printed as a ``phase_seconds`` line."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    PHASE_SECONDS[name] = time.perf_counter() - t0
    emit("phase_seconds", name=name, seconds=PHASE_SECONDS[name])
    return out


def cuda_ms(fn, iters: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int) -> float:
    """Device ms per call of ``fn``: the timed launches queue behind a sleep
    kernel that outlasts the host's time to enqueue them, so the events read
    the card's time alone and not the wrapper's Python overhead (a call of
    a short kernel costs the host more than the card)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        fn()
    host_s = (time.perf_counter() - t0) / 3
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int((2 * iters * host_s + 2e-3) * 2e9))  # cycles, at most ~2 GHz
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def l2_cold(fn, *tensors, clone=None):
    """``(call, copies)``: ``call()`` runs ``fn`` on the next of enough
    copies of ``tensors`` to fill the L2 twice, so a timed loop of it reads
    its inputs from HBM, as the bound counts them. ``clone`` makes a copy
    (default ``Tensor.clone``; ``off_base`` keeps a misaligned base)."""
    clone = clone or (lambda t: t.clone())
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    copies = [tensors] + [
        tuple(clone(t) for t in tensors) for _ in range(max(2, math.ceil(2 * L2_BYTES / nbytes)) - 1)
    ]
    turn = itertools.cycle(copies)
    return (lambda: fn(*next(turn))), len(copies)


# K1's cases: (name, i, j, left pads, visible keys) per batch row, b = 4;
# ``visible`` masks the keys at and past each row's count
K1_CASES = (
    ("cross", 512, 1024, [0, 100, 600, 900], None),        # rows 0..387 of row 3 dead
    ("stack", 512, 512, [0, 10, 200, 400], None),          # not-yet-latent slots masked
    ("decode", 1, 1024, None, [1024, 701, 301, 41]),       # keys past the cache length masked
    ("ragged", 100, 612, [0, 30, 300, 560], None),         # ragged q and kv tiles; rows 0..47 of row 3 dead
    ("decode_empty", 1, 1024, None, [0, 64, 200, 700]),    # whole splits masked; row 0 dead
    # a k4 verify's 4 slots x 5 lanes (b = 20, row i*5 + j is slot i's lane j),
    # each lane its own pad: window pads 524/400/100/0 less j+1, and stack
    # pads 512 - min(m + j + 1, 512) for latent counts 3, 200, 508 and 512
    # (rows below a lane's first live latent are dead)
    ("verify_cross", 512, 1024, [max(p - j - 1, 0) for p in (524, 400, 100, 0) for j in range(5)],
     None),
    ("verify_stack", 512, 512, [512 - min(m + j + 1, 512) for m in (3, 200, 508, 512)
                                for j in range(5)], None),
)
K1_HEAD_DIM = 112  # clm-base: 896 channels over 8 heads
# the kernels' other head dims, each case but the ragged one, timed over
# fewer iterations
K1_OTHER_HEAD_DIMS = (64, 96, 128)
# head dims that K1-K3 instantiate (as d = dv) and K4 does not, held in the
# same cases
K13_ONLY_HEAD_DIMS = (32,)
K1_OTHER_CASES = ("cross", "stack", "decode", "decode_empty")
# K1 at the symbolic-audio model's GiantMIDI shapes (d = 96): the cross
# attend of 2048 latents over 6144 keys (row 1's 4200 left pads reach 104
# rows into the latents), the latent stack (row 1's first 300 latent slots
# not yet latents) and a decode attend over up to 6144 cached keys
K1_SAM_CASES = (
    ("cross_sam", 2048, 6144, [0, 4200], None),
    ("stack_sam", 2048, 2048, [0, 300], None),
    ("decode_sam", 1, 6144, None, [6144, 4097, 2001, 65]),
)


# K1's non-causal cases (the Perceiver IO families' attends are all
# non-causal): (name, i, j, left pads, visible keys, d, dv). First at
# clm-base's shapes (d = 112), each tile route; row 3's every key padded, so
# all its rows are dead. Then the masked LM's three attends at
# language-perceiver width (8 heads over qk 256: d = 32; v 1280 in the
# encoder, dv = 160, and d_model 768 in the decoder, dv = 96): the encoder's
# cross attend of 256 latents over 2048 right-padded tokens (row 3 all pad:
# a dead batch row), its 26 self-attends (256 x 256, no pad mask) and the
# decoder's cross attend of 2048 output queries over the 256 latents; and a
# split case with dv != d.
K1_NONCAUSAL_CASES = (
    ("cross_nc", 512, 1024, [0, 100, 600, 1024], None, 112, 112),
    ("stack_nc", 512, 512, None, None, 112, 112),
    ("mlm_enc_cross", 256, 2048, None, [2048, 1500, 700, 0], 32, 160),
    ("mlm_self", 256, 256, None, None, 32, 160),
    ("mlm_dec_cross", 2048, 256, None, None, 32, 96),
    ("mlm_split", 1, 2048, None, [2048, 1500, 700, 0], 32, 160),
)


# K1's cases at this slice's widths: (name, i, j, left pads, visible keys, d,
# dv, causal, heads, batch). The text classifier at the JAX CLI's defaults (8
# heads over 1280 latent channels: (160, 160) on the tile routes): its
# encoder cross attend of 256 latents over 2048 tokens (row 3 all pad: dead
# rows), a self-attend, and its decoder's one query over the 256 latents
# (split). Then the wide_mma route: the Fourier image classifier's encoder cross
# attend at deepmind/vision-perceiver-fourier width (one head of 3 + 2 *
# (2 * 64 + 1) = 261 over 224 * 224 = 50176 pixels, b = 2), its decoder's one
# query over 512 latents (one head of 1024), and MNIST's cross attend (one
# head of 1 + 2 * (2 * 32 + 1) = 131 over 784 pixels; pads and a dead batch
# row, which the image path does not have, to hold the dead-row zeros).
# Then wide_mma's causal masking at an odd head dim: 100 rows right-aligned over
# 300 keys (ragged row and key tiles), row 2's pads leaving its rows 0..59
# dead and row 3 all pad
K1_CLASSIFIER_CASES = (
    ("clf_enc_cross", 256, 2048, None, [2048, 1500, 700, 0], 160, 160, False, 8, 4),
    ("clf_self", 256, 256, None, None, 160, 160, False, 8, 4),
    ("clf_dec_cross", 1, 256, None, None, 160, 160, False, 8, 4),
    ("img_cross", 512, 50176, None, None, 261, 261, False, 1, 2),
    ("img_dec_cross", 1, 512, None, None, 1024, 1024, False, 1, 4),
    ("mnist_cross", 32, 784, None, [784, 784, 500, 0], 131, 131, False, 1, 4),
    ("wide_causal", 100, 300, [0, 30, 260, 300], None, 131, 131, True, 2, 4),
    # the edges of K1's wide_mma design: i = 16 and 17 around its 16-row
    # tiles (causal, pads, dead rows); v wider than a warp's 272 columns
    # beside a narrow q/k, so the block's 8 warps split dv = 1024 (causal
    # over j > i, a dead batch row); q/k wider than 272 beside a narrow v
    # (the column split at dv = 40); and the image's d = 261 with q, k and v
    # one element off a 16-byte boundary (bf16 off the flat spans, staged
    # through registers; K1_MISALIGNED)
    ("wide_i16", 16, 300, [0, 30, 290, 300], None, 261, 261, True, 2, 4),
    ("wide_i17", 17, 300, [0, 30, 290, 300], None, 261, 261, True, 2, 4),
    ("wide_cols", 70, 130, None, [130, 64, 1, 0], 64, 1024, True, 1, 4),
    ("wide_deep", 5, 300, [0, 30, 290, 300], None, 300, 40, True, 2, 4),
    ("wide_misaligned", 100, 300, [0, 30, 260, 300], None, 261, 261, True, 1, 4),
)
#: the K1 cases whose q, k and v lie one element off a 16-byte boundary
K1_MISALIGNED = ("wide_misaligned",)
# K1 at optical flow's attends (deepmind/optical-flow-perceiver width, b =
# 1, non-causal, no pad mask): the encoder's cross attend of 2048 latents
# over the 368 * 496 = 182528 pixels of a patch at (322, 322) and the
# decoder's 182528 per-pixel queries over the 2048 latents at (512, 512),
# both past wide_mma's 272 columns (its column split: 16-row tiles, the
# warps over the output's columns); and a self-attend, 16 heads of 32 over
# the 2048 latents. No earlier design runs beside them (prev_ms null): the
# first wide design's yardstick stays at the image's shapes
K1_FLOW_CASES = (
    ("flow_enc_cross", 2048, 182528, None, None, 322, 322, False, 1, 1),
    ("flow_dec_cross", 182528, 2048, None, None, 512, 512, False, 1, 1),
    ("flow_self", 2048, 2048, None, None, 32, 32, False, 16, 1),
)
#: the wide routes' timed iterations at the image encoder's 512 x 50176
#: cross attend and at optical flow's attends: (kernel, plain version)
WIDE_ITERS = (10, 2)


def off_base(t):
    """A contiguous copy of ``t`` one element past a 16-byte boundary."""
    import torch

    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    buf[1:].copy_(t.reshape(-1))
    return buf[1:].view(t.shape)


def k1_expected_route(i: int, tname: str, d: int, dv: int, head_dims) -> str:
    """K1's route for the case: ``wide_mma`` for a pair outside
    ``head_dims`` (the tile routes' pairs), else by the query rows and the
    type."""
    if (d, dv) not in head_dims:
        return K1_WIDE_ROUTE
    return "split" if i <= 16 else ("wgmma" if tname == "bfloat16" else "tf32x3")


def case_mask(torch, i: int, j: int, pads, visible, causal: bool, b: int = 4):
    """``(pad, allowed)`` of a kernel case: the ``(b, j)`` pad mask (left
    ``pads`` per batch row, or keys at and past ``visible``; None when both
    are None) and the ``(b, i, j)`` mask of the pairs the kernel scores."""
    cols = torch.arange(j, device="cuda")[None, :]
    if pads is not None:
        pad = cols < torch.tensor(pads, device="cuda")[:, None]
    elif visible is not None:
        pad = cols >= torch.tensor(visible, device="cuda")[:, None]
    else:
        pad = None
    allowed = torch.ones(i, j, dtype=torch.bool, device="cuda")
    if causal:
        allowed = cols <= torch.arange(i, device="cuda")[:, None] + (j - i)
    allowed = allowed[None].expand(b, i, j)
    if pad is not None:
        allowed = allowed & ~pad[:, None, :]
    return pad, allowed


def library_time(fn, iters: int):
    """``(ms, backend, note)`` of the library yardstick under the pinned
    SDPA backend, or under SDPA's math backend where that one refuses the
    shapes (head dims 261 and 131; ``note`` says why), or ``(None, None,
    why)`` where both refuse."""
    notes = []
    for backend in (SDPA_BACKEND, SDPA_FALLBACK):
        try:
            with sdpa_backend(backend):
                return device_ms(fn, iters), backend, "; ".join(notes) or None
        except RuntimeError as e:
            notes.append(f"{backend} refused: {str(e).splitlines()[0][:160]}")
    return None, None, "; ".join(notes)


SDPA_BACKEND = "EFFICIENT_ATTENTION"
# the yardstick where the memory-efficient backend refuses the head dims
SDPA_FALLBACK = "MATH"


def sdpa_backend(backend: str = SDPA_BACKEND):
    """A context that pins the library yardstick's backend: memory-efficient
    attention, which takes a boolean mask in fp32 and bf16 (a call it
    refuses raises instead of moving to another backend), or ``backend``."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    return sdpa_kernel(getattr(SDPBackend, backend))


def _k1_errors(flash, o, lse, o_ref, lse_ref, live) -> tuple:
    """``(max|o - o_ref|, max|lse - lse_ref|)`` on live rows, and whether
    every dead row has ``o`` exactly 0 and ``lse`` the mask value."""
    live4 = live[:, None, :, None].expand_as(o)
    live3 = live[:, None, :].expand_as(lse)
    err = (o.float() - o_ref.float()).abs()[live4].max().item()
    lse_err = (lse - lse_ref).abs()[live3].max().item()
    dead_zero = (bool((o[~live4] == 0).all().item())
                 and bool((lse[~live3] == flash.MASK_VALUE).all().item()))
    return err, lse_err, dead_zero


def kernel_cases(torch, flash):
    """K1 against its plain version at the serving path's shapes, through
    the route the wrapper picks, beside the earlier design on the same
    inputs (``prev_ms``: the first CUDA-core kernel, ``simt``, at its head
    dims, the first ``wide`` design at the pairs outside ``HEAD_DIMS``),
    itself held to the same gates; at head dim 112 and at the kernels'
    other head dims."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(0)
    shapes = [(*c, K1_HEAD_DIM, K1_HEAD_DIM, True, 8, None) for c in K1_CASES] + [
        (*c, d, d, True, 8, None) for d in K1_OTHER_HEAD_DIMS + K13_ONLY_HEAD_DIMS for c in K1_CASES
        if c[0] in K1_OTHER_CASES] + [
        (*c, SAM_HEAD_DIM, SAM_HEAD_DIM, True, 8, None) for c in K1_SAM_CASES] + [
        (*c, False, 8, None) for c in K1_NONCAUSAL_CASES] + list(K1_CLASSIFIER_CASES) + list(K1_FLOW_CASES)
    cases = []
    for name, i, j, pads, visible, d, dv, causal, h, b in shapes:
        b = len(pads) if pads is not None else len(visible) if visible is not None else b or 4
        pad, allowed = case_mask(torch, i, j, pads, visible, causal, b)  # allowed: (b, i, j)
        live = allowed.any(-1)  # (b, i)
        seen = int(allowed.any(1).sum().item())  # keys some row sees: the only k/v rows read
        pairs = int(allowed.sum().item()) * h
        main_dim = d == K1_HEAD_DIM and causal
        sam = name.endswith("_sam")
        # the simt kernel keeps (64, 112, 128) x itself; wide takes every pair outside HEAD_DIMS
        flow_case = name.startswith("flow_")
        prev_route = (None if flow_case else K1_WIDE_PREV if (d, dv) not in flash.HEAD_DIMS
                      else "simt" if (d, dv) in flash.SIMT_HEAD_DIMS else None)
        with_prev = prev_route is not None
        clone = off_base if name in K1_MISALIGNED else None
        for dtype in (torch.float32, torch.bfloat16):
            tname = str(dtype).split(".")[-1]
            q = (torch.randn(b, h, i, d, generator=gen, device="cuda") * d**-0.5).to(dtype)
            k = torch.randn(b, h, j, d, generator=gen, device="cuda").to(dtype)
            v = torch.randn(b, h, j, dv, generator=gen, device="cuda").to(dtype)
            if clone:
                q, k, v = (clone(t) for t in (q, k, v))
            before = dict(flash.flash_attention.route_launches)
            o, lse = flash.flash_attention_fwd(q, k, v, pad_mask=pad, causal=causal)
            route = next(r for r, n in flash.flash_attention.route_launches.items() if n != before[r])
            o_ref, lse_ref = flash.flash_attention_reference(q, k, v, pad_mask=pad, causal=causal)
            torch.cuda.synchronize()
            err, lse_err, dead_zero = _k1_errors(flash, o, lse, o_ref, lse_ref, live)
            ref_max = o_ref.float().abs().max().item()
            prev_err = prev_lse_err = None
            prev_dead_zero = True
            if with_prev:
                o_prev, lse_prev = flash._fwd_launch(prev_route, q, k, v, pad, causal)
                prev_err, prev_lse_err, prev_dead_zero = _k1_errors(flash, o_prev, lse_prev, o_ref,
                                                                    lse_ref, live)
                del o_prev, lse_prev
            tol = KERNEL_TOL[tname]
            if tname == "bfloat16" and ((d, dv) not in flash.HEAD_DIMS or flow_case):
                # the wide pairs' outputs are small (|o| ~0.03 over 50176
                # keys): the gate scales with the reference, as a flat 2e-2
                # would pass a dropped P.V term of that size (the flow cases
                # all take this gate)
                tol = min(tol, 8 * bf16_ulp(ref_max))
            expected = k1_expected_route(i, tname, d, dv, flash.HEAD_DIMS)
            if not (err <= tol and lse_err <= 1e-3 and dead_zero and route == expected):
                raise AssertionError(
                    f"K1 {name} d={d} dv={dv} {tname} ({route}, expected {expected}): max|d| {err} "
                    f"(tol {tol}), lse {lse_err}, dead rows 0 with lse MASK {dead_zero}"
                )
            if with_prev and not (prev_err <= tol and prev_lse_err <= 1e-3 and prev_dead_zero):
                raise AssertionError(
                    f"K1 {prev_route} (prev_ms) {name} d={d} {tname}: max|d| {prev_err} (tol {tol}), "
                    f"lse {prev_lse_err}, dead rows 0 with lse MASK {prev_dead_zero}"
                )
            del o_ref, lse_ref
            iters = (100 if i > 1 else 200) if main_dim else (30 if i > 1 else 50)
            plain_iters = 10 if main_dim else 3
            if sam:
                iters, plain_iters = SAM_ITERS
            if max(i, j) >= 50176:
                iters, plain_iters = WIDE_ITERS
            attn_mask = allowed[:, None]
            kernel, copies = l2_cold(
                lambda q, k, v: flash.flash_attention_fwd(q, k, v, pad_mask=pad, causal=causal), q, k, v, clone=clone)
            plain, _ = l2_cold(
                lambda q, k, v: flash.flash_attention_reference(q, k, v, pad_mask=pad, causal=causal),
                q, k, v)
            library, _ = l2_cold(
                lambda q, k, v: F.scaled_dot_product_attention(q, k, v, attn_mask=attn_mask, scale=1.0),
                q, k, v)
            ms = device_ms(kernel, iters)
            prev_ms = None
            if with_prev:
                prev, _ = l2_cold(lambda q, k, v: flash._fwd_launch(prev_route, q, k, v, pad, causal), q, k, v,
                                  clone=clone)
                prev_ms = device_ms(prev, iters)
                del prev
            plain_ms = device_ms(plain, plain_iters)
            library_ms, library_backend, library_note = library_time(library, iters)
            del kernel, plain, library
            torch.cuda.empty_cache()
            esize = q.element_size()
            nbytes = ((q.numel() + o.numel() + seen * h * (d + dv)) * esize + lse.numel() * 4
                      + (0 if pad is None else pad.numel()))
            flops = (2 * d + 2 * dv) * pairs  # q.k and p.v over the keys this data lets each row see
            bytes_s, ops_s = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[tname]
            case = dict(
                case=name, dtype=tname, route=route, b=b, h=h, i=i, j=j, d=d, dv=dv, causal=causal,
                max_abs_err=err, tol=tol, ref_max_abs=ref_max, lse_max_abs_err=lse_err,
                dead_rows=int((~live).sum().item()), dead_rows_zero_lse_mask=dead_zero, ms=ms,
                prev_ms=prev_ms, prev_route=prev_route, misaligned=bool(clone),
                prev_max_abs_err=prev_err, prev_lse_max_abs_err=prev_lse_err,
                plain_ms=plain_ms, library_ms=library_ms, library_backend=library_backend,
                library_note=library_note, input_copies=copies, iters=iters,
            )
            if tname == "float32" and route in ("tf32x3", K1_WIDE_ROUTE):
                # the card's fp32-accurate rate is the tensor cores' TF32 rate
                # over three; the CUDA cores' bound stays beside it so rows
                # compare with those of the simt and wide routes (the first
                # wide design, the wide_mma cases' prev_ms, runs on the CUDA
                # cores)
                case.update(bound_simt_ms=max(bytes_s, ops_s) * 1e3,
                            bound_simt_by="bytes" if bytes_s >= ops_s else "operations")
                ops_s = 3 * flops / TF32_FLOPS
            case.update(bound_ms=max(bytes_s, ops_s) * 1e3,
                        bound_by="bytes" if bytes_s >= ops_s else "operations",
                        bytes=nbytes, flops=flops, seen_keys=seen)
            emit("kernel", **case)
            cases.append(case)
    return cases


def k1_refusals(torch, flash) -> None:
    """K1's split, wgmma and tf32x3 routes refuse a query on a base off a
    16-byte boundary, at head dims 112 and 96: the wrapper raises
    ``ValueError`` and counts no launch. The simt kernel refuses a v of
    another head dim than q's."""
    seen = {}
    for d in (K1_HEAD_DIM, SAM_HEAD_DIM):
        for route, i, dtype in (("split", 1, torch.bfloat16), ("wgmma", 64, torch.bfloat16),
                                ("tf32x3", 64, torch.float32)):
            # contiguous, one element (2 or 4 bytes) off the allocation's base
            q = torch.randn(2 * 8 * i * d + 1, device="cuda").to(dtype)[1:].view(2, 8, i, d)
            k = torch.randn(2, 8, 128, d, device="cuda").to(dtype)
            before = (flash.flash_attention.launches, dict(flash.flash_attention.route_launches))
            message = None
            try:
                flash.flash_attention_fwd(q, k, k, causal=True)
            except ValueError as e:
                message = str(e)
            counted = (flash.flash_attention.launches, dict(flash.flash_attention.route_launches)) != before
            seen[f"{route} d={d}"] = dict(picked=flash._fwd_route(i, dtype, d, d), message=message, counted=counted)
    # the simt kernel takes v of q's head dim only: a v of its own width is
    # refused before its library loads
    q = torch.randn(2, 8, 64, K1_HEAD_DIM, device="cuda")
    v = torch.randn(2, 8, 128, 96, device="cuda")
    simt = None
    try:
        flash._fwd_launch("simt", q, torch.randn(2, 8, 128, K1_HEAD_DIM, device="cuda"), v, None, False)
    except ValueError as e:
        simt = str(e)
    emit("k1_refusal", routes=seen, simt_dv=simt)
    for key, r in seen.items():
        if (r["picked"] != key.split()[0] or r["message"] is None or "16-byte" not in r["message"]
                or r["counted"]):
            raise AssertionError(f"K1 {key} did not refuse a misaligned query: {r}")
    if simt is None or "v of q's head dim" not in simt:
        raise AssertionError(f"K1 simt did not refuse v of head dim 96 against q's {K1_HEAD_DIM}: {simt}")


def _grad_rotation(torch, F, q, k, v, do, attn_mask, backend: str = SDPA_BACKEND):
    """``(call, copies)``: ``call()`` runs the backward alone of
    ``scaled_dot_product_attention`` (``backend`` pinned: memory-efficient
    unless it refuses) on the next of enough kept graphs (input copies) to
    fill the L2 twice: the library yardstick of K2 and K3."""
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, do))
    graphs = []
    for _ in range(max(2, math.ceil(2 * L2_BYTES / nbytes))):
        qq, kk, vv = (t.detach().clone().requires_grad_() for t in (q, k, v))
        with sdpa_backend(backend):
            out = F.scaled_dot_product_attention(qq, kk, vv, attn_mask=attn_mask, scale=1.0)
        graphs.append((out, (qq, kk, vv), do.clone()))
    turn = itertools.cycle(graphs)

    def call():
        out, inputs, cot = next(turn)
        return torch.autograd.grad(out, inputs, cot, retain_graph=True)

    return call, len(graphs)


def k23_cases(torch, flash):
    """K2 and K3 against their plain versions at the training path's shapes
    (module docstring), through the route the wrappers pick, beside the
    earlier design on the same inputs (``prev_ms``: the ``simt`` kernels at
    their head dims, ``wide`` at the pairs outside ``HEAD_DIMS``): dead rows'
    dq and padded keys' dk/dv exactly 0; bf16 also against the fp32 oracle."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(5)
    wrappers = {"dq": flash.flash_attention_bwd_dq, "dkv": flash.flash_attention_bwd_dkv}
    cases = []
    shapes = [(name, i, j, pads, None, d, d, True, 4, 8) for name, i, j, pads, d in K23_CASES] + [
        (*c, False, 4, 8) for c in K23_NONCAUSAL_CASES] + list(K23_CLASSIFIER_CASES)
    for name, i, j, pads, visible, d, vd, causal, b, h in shapes:
        pad, allowed = case_mask(torch, i, j, pads, visible, causal, b)
        live = allowed.any(-1)  # (b, i) rows that see a key
        seen = allowed.any(1)   # (b, j) keys that some row sees
        pairs = int(allowed.sum().item()) * h
        for dtype in (torch.float32, torch.bfloat16):
            tname = str(dtype).split(".")[-1]
            q = (torch.randn(b, h, i, d, generator=gen, device="cuda") * d**-0.5).to(dtype)
            k = torch.randn(b, h, j, d, generator=gen, device="cuda").to(dtype)
            v = torch.randn(b, h, j, vd, generator=gen, device="cuda").to(dtype)
            do = torch.randn(b, h, i, vd, generator=gen, device="cuda").to(dtype)
            o, lse = flash.flash_attention_fwd(q, k, v, pad_mask=pad, causal=causal)
            delta = flash.attention_delta(o, do)
            kw = dict(pad_mask=pad, causal=causal)
            before = {n: dict(f.route_launches) for n, f in wrappers.items()}
            dq = flash.flash_attention_bwd_dq(q, k, v, lse, delta, do, **kw)
            dk, dv = flash.flash_attention_bwd_dkv(q, k, v, lse, delta, do, **kw)
            routes = {n: [r for r, c in f.route_launches.items() if c != before[n][r]]
                      for n, f in wrappers.items()}
            ref = flash.flash_attention_backward_reference(q, k, v, o, lse, do, **kw)
            torch.cuda.synchronize()
            errs, rel = {}, {}
            for gname, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
                errs[gname] = (got.float() - want.float()).abs().max().item()
                rel[gname] = errs[gname] / want.float().abs().max().item()
            oracle, exact = {}, None
            if dtype == torch.bfloat16:
                q32, k32, v32, do32 = (t.float() for t in (q, k, v, do))
                o32, lse32 = flash.flash_attention_reference(q32, k32, v32, **kw)
                exact = flash.flash_attention_backward_reference(q32, k32, v32, o32, lse32, do32, **kw)
                for gname, got, plain, want in zip(("dq", "dk", "dv"), (dq, dk, dv), ref, exact):
                    kernel_err = (got.float() - want).abs().max().item()
                    plain_err = (plain.float() - want).abs().max().item()
                    oracle[gname] = dict(kernel=kernel_err, plain=plain_err,
                                         ratio=kernel_err / plain_err if plain_err > 0 else math.inf)
                del q32, k32, v32, do32, o32, lse32
            dead_zero = bool((dq[~live[:, None, :, None].expand_as(dq)] == 0).all().item())
            unseen = ~seen[:, None, :, None]
            unseen_zero = bool((dk[unseen.expand_as(dk)] == 0).all().item()
                               and (dv[unseen.expand_as(dv)] == 0).all().item())
            finite = all(bool(torch.isfinite(t).all().item()) for t in (dq, dk, dv))
            tol = K23_REL_TOL[tname]
            expected = K23_ROUTE[tname] if (d, vd) in flash.HEAD_DIMS else K23_WIDE_ROUTE
            case = dict(case=name, dtype=tname, route=routes, expected_route=expected, b=b, h=h, i=i,
                        j=j, d=d, dv=vd, causal=causal, max_abs_err=errs, rel_err=rel, rel_tol=tol,
                        oracle_err=oracle,
                        oracle_ratio_tol=K23_ORACLE_RATIO if oracle else None,
                        dead_rows=int((~live).sum().item()), dead_rows_dq_zero=dead_zero,
                        unseen_keys=int((~seen).sum().item()), unseen_keys_dkdv_zero=unseen_zero,
                        finite=finite)
            if not (max(rel.values()) <= tol and dead_zero and unseen_zero and finite
                    and all(r == [expected] for r in routes.values())
                    and all(e["ratio"] <= K23_ORACLE_RATIO for e in oracle.values())):
                emit("k23", **case)
                raise AssertionError(f"K2/K3 {name} i={i} j={j} {tname}: routes {routes} (expected "
                                     f"{expected}), rel err {rel} (tol {tol}), oracle {oracle}, "
                                     f"dead dq zero {dead_zero}, unseen dk/dv zero {unseen_zero}, "
                                     f"finite {finite}")
            # the earlier design times prev_ms below, held first to its bar:
            # the simt kernels to the one they had as the fp32 route (and as
            # the bf16 one before the wgmma route), 1e-4 of each output's
            # largest plain entry (they do not instantiate d = 96); wide, at
            # the pairs outside HEAD_DIMS, to the gates of the route above
            t6 = (q, k, v, lse, delta, do)
            wide_pair = (d, vd) not in flash.HEAD_DIMS
            prev_route = K23_WIDE_PREV if wide_pair else "simt" if (d, vd) in flash.SIMT_HEAD_DIMS else None
            prev_tol = tol if wide_pair else SIMT_REL_TOL
            prev_ok, prev_abs, prev_rel, prev_oracle = True, None, None, {}
            if prev_route:
                pdq, pdk, pdv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
                flash._bwd_launch(prev_route, *t6, pad, causal, 0, (pdq,))
                flash._bwd_launch(prev_route, *t6, pad, causal, 1, (pdk, pdv))
                torch.cuda.synchronize()
                prev_abs = {gname: (got.float() - want.float()).abs().max().item()
                            for gname, got, want in zip(("dq", "dk", "dv"), (pdq, pdk, pdv), ref)}
                prev_rel = {gname: prev_abs[gname] / want.float().abs().max().item()
                            for gname, want in zip(("dq", "dk", "dv"), ref)}
                if wide_pair and exact is not None:
                    for gname, got, plain, want in zip(("dq", "dk", "dv"), (pdq, pdk, pdv), ref, exact):
                        prev_err = (got.float() - want).abs().max().item()
                        plain_err = (plain.float() - want).abs().max().item()
                        prev_oracle[gname] = prev_err / plain_err if plain_err > 0 else math.inf
                prev_ok = (max(prev_rel.values()) <= prev_tol
                           and all(r <= K23_ORACLE_RATIO for r in prev_oracle.values())
                           and all(bool(torch.isfinite(t).all().item()) for t in (pdq, pdk, pdv))
                           and bool((pdq[~live[:, None, :, None].expand_as(pdq)] == 0).all().item())
                           and bool((pdk[unseen.expand_as(pdk)] == 0).all().item()
                                    and (pdv[unseen.expand_as(pdv)] == 0).all().item()))
                del pdq, pdk, pdv
            with_prev = prev_route is not None
            case.update(prev_route=prev_route, prev_max_abs_err=prev_abs, prev_rel_err=prev_rel, prev_rel_tol=prev_tol,
                        prev_oracle_ratio=prev_oracle or None)
            del ref, exact
            if not prev_ok:
                emit("k23", **case)
                raise AssertionError(f"K2/K3 {prev_route} (prev_ms) {name} i={i} j={j} {tname}: rel err "
                                     f"{prev_rel} (tol {prev_tol}), oracle ratio {prev_oracle}, or an output "
                                     f"not finite, or a dead row's dq or an unseen key's dk/dv not 0")
            esize = q.element_size()
            pad_bytes = 0 if pad is None else pad.numel()
            kv_read = int(seen.sum().item()) * h * (d + vd) * esize  # k and v of the keys some row sees
            iters, plain_iters, library_iters = (30, 5, 20)
            if name.endswith("_sam"):
                iters, plain_iters = SAM_ITERS
                library_iters = iters
            if max(i, j) >= 50176:
                iters, plain_iters = WIDE_ITERS
                library_iters = iters
            times = {}
            # bytes: q and do in, dq out (K2), or q and do in, dk and dv out
            # (K3), beside lse and delta and the k/v rows some row sees;
            # flops per visible pair: K2 4d + 2dv (S, dP, dQ), K3 4d + 4dv
            # (S^T, dP^T, dV, dK), with d q/k's head dim and vd v's
            for kname, which, kernel, plain, nbytes, flops in (
                ("dq", 0, flash.flash_attention_bwd_dq, flash.flash_attention_bwd_dq_reference,
                 b * h * ((2 * d + vd) * i * esize + 8 * i) + kv_read + pad_bytes, (4 * d + 2 * vd) * pairs),
                ("dkv", 1, flash.flash_attention_bwd_dkv, flash.flash_attention_bwd_dkv_reference,
                 b * h * ((i + j) * (d + vd) * esize + 8 * i) + kv_read + pad_bytes,
                 (4 * d + 4 * vd) * pairs),
            ):
                timed, copies = l2_cold(lambda *t, f=kernel: f(*t, **kw), q, k, v, lse, delta, do)
                ms = device_ms(timed, iters)
                outs = (lambda t: (torch.empty_like(t[0]),)) if which == 0 else (
                    lambda t: (torch.empty_like(t[1]), torch.empty_like(t[2])))
                prev_ms = None
                if with_prev:
                    prev, _ = l2_cold(
                        lambda *t, w=which, outs=outs: flash._bwd_launch(prev_route, *t, pad, causal, w, outs(t)),
                        q, k, v, lse, delta, do)
                    prev_ms = device_ms(prev, iters)
                    del prev
                plain_ms = device_ms(l2_cold(lambda *t, f=plain: f(*t, **kw), q, k, v, lse, delta, do)[0],
                                     plain_iters)
                bytes_s, ops_s = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[tname]
                times[kname] = dict(route=expected, ms=ms, prev_ms=prev_ms, prev_route=prev_route,
                                    plain_ms=plain_ms, bytes=nbytes, flops=flops, input_copies=copies)
                if tname == "float32":
                    # the card's fp32-accurate rate is the tensor cores' TF32
                    # rate over three; the CUDA cores' bound stays beside it
                    # so rows compare with those of the simt and wide routes
                    times[kname].update(bound_simt_ms=max(bytes_s, ops_s) * 1e3,
                                        bound_simt_by="bytes" if bytes_s >= ops_s else "operations")
                    ops_s = 3 * flops / TF32_FLOPS
                times[kname].update(bound_ms=max(bytes_s, ops_s) * 1e3,
                                    bound_by="bytes" if bytes_s >= ops_s else "operations")
                del timed
                torch.cuda.empty_cache()
            attn_mask = allowed[:, None]
            graphs, library_ms, library_backend, refused = 0, None, None, []
            for backend in (SDPA_BACKEND, SDPA_FALLBACK):
                try:
                    library, graphs = _grad_rotation(torch, F, q, k, v, do, attn_mask, backend)
                    library_ms, library_backend = device_ms(library, library_iters), backend
                    del library
                    break
                except RuntimeError as e:
                    refused.append(f"{backend} refused: {str(e).splitlines()[0][:160]}")
            torch.cuda.empty_cache()
            case.update(kernels=times, library_ms=library_ms, library_graphs=graphs,
                        library_backend=library_backend, library_refused="; ".join(refused) or None,
                        library_note="backward of scaled_dot_product_attention (dq, dk, dv together)")
            emit("k23", **case)
            cases.append(case)
    return cases


def clm_base_config(CausalLanguageModelConfig):
    # docs/pretrained-models.md "C4 CLM, 455M"; examples/convert.py
    return CausalLanguageModelConfig(
        vocab_size=32000, max_seq_len=1024, max_latents=512, num_channels=896, num_heads=8,
        num_self_attention_layers=16, self_attention_widening_factor=4,
        cross_attention_widening_factor=4, abs_pos_emb=True, output_bias=True, output_norm=False,
    )


def set_attention_impl(model, impl: str) -> None:
    from perceiver_io_tpu_torch.models.core.modules import MultiHeadAttention

    for m in model.modules():
        if isinstance(m, MultiHeadAttention):
            m.attention_impl = impl


FUSED_ENV = "PERCEIVER_FUSED_QKV"
#: phase 4's fused generate(): prompts, their length, latents, new tokens
FUSED_PROMPTS, FUSED_PROMPT_LEN, FUSED_LATENTS, FUSED_NEW = 4, 480, 64, 32


@contextlib.contextmanager
def fused_qkv(on: bool):
    """``PERCEIVER_FUSED_QKV`` set to ``1`` (or unset) within the block."""
    before = os.environ.pop(FUSED_ENV, None)
    if on:
        os.environ[FUSED_ENV] = "1"
    try:
        yield
    finally:
        os.environ.pop(FUSED_ENV, None)
        if before is not None:
            os.environ[FUSED_ENV] = before


def count_gemms(torch, fn) -> int:
    """The GEMM calls (aten ``mm``, ``addmm``, ``bmm``) ``fn()`` makes."""
    from torch.utils._python_dispatch import TorchDispatchMode

    gemms = {torch.ops.aten.mm.default, torch.ops.aten.addmm.default, torch.ops.aten.bmm.default}

    class Count(TorchDispatchMode):
        calls = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.calls += func in gemms
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return Count.calls


def fused_forward(torch, flash, model, x, prefix_len: int, logits, tol: float, smi: str) -> None:
    """Phase 4's fused forward: ``PERCEIVER_FUSED_QKV=1`` against the
    unfused kernel forward ``logits``, within the phase's gate ``tol``, with
    equal K1 launches; GEMM calls and forward ms of both."""
    runs = {}
    for on in (False, True):
        with fused_qkv(on), torch.no_grad():
            reset_counts(flash)
            out = model(x, prefix_len=prefix_len)
            torch.cuda.synchronize()
            runs[on] = dict(out=out, k1=flash.flash_attention.launches,
                            k1_routes={r: n for r, n in flash.flash_attention.route_launches.items() if n},
                            gemms=count_gemms(torch, lambda: model(x, prefix_len=prefix_len)),
                            ms=cuda_ms(lambda: model(x, prefix_len=prefix_len), 3))
    err = (runs[True]["out"].float() - logits.float()).abs().max().item()
    emit("model_fused", dtype=str(model.dtype).split(".")[-1], max_abs_err_vs_unfused=err, tol=tol,
         k1_launches={"unfused": runs[False]["k1"], "fused": runs[True]["k1"]},
         k1_route_launches=runs[True]["k1_routes"],
         gemm_calls={"unfused": runs[False]["gemms"], "fused": runs[True]["gemms"]},
         forward_ms={"unfused": runs[False]["ms"], "fused": runs[True]["ms"]}, nvidia_smi=smi)
    if not (err <= tol and runs[True]["k1"] == runs[False]["k1"] > 0
            and runs[True]["gemms"] < runs[False]["gemms"]):
        raise AssertionError(f"fused forward {model.dtype}: max|d| {err} (tol {tol}), K1 "
                             f"{runs[False]['k1']} -> {runs[True]['k1']}, GEMMs {runs[False]['gemms']} -> "
                             f"{runs[True]['gemms']}")


def fused_generate(torch, flash, gen_mod, model, smi: str) -> None:
    """Phase 4's fused ``generate()`` at bf16 (the decode steps' k/v in one
    product, 17 a step): unfused, fused, fused, unfused; tokens equal under
    the near-tie rule, ms a step of each run."""
    g = torch.Generator().manual_seed(12)
    prompts = torch.randint(1, model.config.vocab_size, (FUSED_PROMPTS, FUSED_PROMPT_LEN), generator=g)
    cfg = gen_mod.GenerationConfig(max_new_tokens=FUSED_NEW, num_latents=FUSED_LATENTS)
    ids = prompts.cuda()
    rows, ms, k1 = {}, {False: [], True: []}, {}
    for on in (False, True, True, False):
        with fused_qkv(on):
            reset_counts(flash)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = gen_mod.generate(model, ids, cfg).cpu()  # ends in a host read
            ms[on].append((time.perf_counter() - t0) * 1e3 / FUSED_NEW)
            k1[on] = flash.flash_attention.launches
        if on in rows and not torch.equal(rows[on], out):
            raise AssertionError(f"fused generate: two runs with the switch {'on' if on else 'off'} differ")
        rows[on] = out
    failures = []
    ref = rows[False].numpy()
    divergences = _divergences(torch, gen_mod, model, rows[True].numpy(), ref, prompts.numpy(),
                               [cfg] * FUSED_PROMPTS, failures)
    emit("model_fused_generate", dtype="bfloat16", prompts=FUSED_PROMPTS, prompt_len=FUSED_PROMPT_LEN,
         num_latents=FUSED_LATENTS, new_tokens=FUSED_NEW,
         tokens_equal=bool(torch.equal(rows[True], rows[False])), divergences=divergences,
         k1_launches={"unfused": k1[False], "fused": k1[True]},
         ms_per_step={"unfused": ms[False], "fused": ms[True]},
         tokens_per_s={"unfused": [FUSED_PROMPTS * 1e3 / t for t in ms[False]],
                       "fused": [FUSED_PROMPTS * 1e3 / t for t in ms[True]]}, nvidia_smi=smi)
    if failures or k1[True] != k1[False]:
        raise AssertionError(f"fused generate: {failures}, K1 {k1[False]} -> {k1[True]}")


def model_phase(torch, clm, flash, gen_mod, smi: str):
    cfg = clm_base_config(clm.CausalLanguageModelConfig)
    g = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randint(1, cfg.vocab_size, (2, cfg.max_seq_len), generator=g, device="cuda")
    for dtype in (torch.float32, torch.bfloat16):
        model = clm.CausalLanguageModel(cfg, dtype=dtype, seed=0).eval()
        n_params = sum(p.numel() for p in model.parameters())
        with torch.no_grad():
            logits = model(x, prefix_len=cfg.max_prefix_len)
            kernel_fwd_ms = cuda_ms(lambda: model(x, prefix_len=cfg.max_prefix_len), 3)
            set_attention_impl(model, "xla")
            plain = model(x, prefix_len=cfg.max_prefix_len)
            plain_fwd_ms = cuda_ms(lambda: model(x, prefix_len=cfg.max_prefix_len), 3)
            set_attention_impl(model, "auto")
        diff = (logits.float() - plain.float()).abs()
        err = diff.max().item()
        if dtype == torch.float32:
            tol = 1e-3
        else:
            # both runs round to bf16 at every layer, in other orders inside
            # attention: allow 8 bf16 units in the last place of the largest logit
            top = plain.float().abs().max().item()
            tol = 8 * 2.0 ** (math.floor(math.log2(top)) - 7)
        finite = bool(torch.isfinite(logits).all().item())
        shape_ok = tuple(logits.shape) == (2, cfg.max_latents, cfg.vocab_size)
        emit("model", dtype=str(dtype).split(".")[-1], params=n_params, logits_shape=list(logits.shape),
             max_abs_err_vs_plain=err, mean_abs_err_vs_plain=diff.mean().item(), tol=tol,
             logits_max_abs=plain.float().abs().max().item(), logits_std=logits.float().std().item(),
             finite=finite, forward_ms=kernel_fwd_ms, plain_forward_ms=plain_fwd_ms)
        if not (err <= tol and finite and shape_ok):
            raise AssertionError(f"full-width forward {dtype}: max|d| {err} (tol {tol})")
        fused_forward(torch, flash, model, x, cfg.max_prefix_len, logits, tol, smi)
        if dtype == torch.bfloat16:
            fused_generate(torch, flash, gen_mod, model, smi)
        del model, logits, plain
        torch.cuda.empty_cache()

    # a small model on the card against the same weights on the CPU
    small = clm.CausalLanguageModelConfig(
        vocab_size=256, max_seq_len=64, max_latents=32, num_channels=128, num_heads=2,
        num_self_attention_layers=2, init_scale=0.1,
    )
    cpu = clm.CausalLanguageModel(small, device="cpu", seed=3).eval()
    card = clm.CausalLanguageModel(small, seed=0).eval()
    card.load_state_dict(cpu.state_dict())
    ids = torch.randint(1, 256, (3, 20), generator=torch.Generator().manual_seed(4))
    pads = torch.tensor([0, 5, 2])
    gcfg = gen_mod.GenerationConfig(max_new_tokens=56, num_latents=8)
    out_cpu = gen_mod.generate(cpu, ids, gcfg, prompt_pad_count=pads, device="cpu")
    out_card = gen_mod.generate(card, ids, gcfg, prompt_pad_count=pads).cpu()
    with torch.no_grad():
        l_cpu = cpu(ids, prefix_len=12)
        l_card = card(ids.cuda(), prefix_len=12).cpu()
    small_err = (l_cpu - l_card).abs().max().item()
    emit("small_model", tokens_equal=bool((out_cpu == out_card).all()),
         logits_max_abs_err_vs_cpu=small_err, tol=1e-4)
    if not (bool((out_cpu == out_card).all()) and small_err <= 1e-4):
        raise AssertionError("small model on the card disagrees with the CPU")


def serve_workload(torch, gen_mod, buckets, vocab_size: int):
    """The serve phase's requests: ``(table, [(config, prompts), ...])``.

    Group A: short prompts, 64 latents -> bucket 512: prefill + 32
    latent-growth steps. Group B: long prompts, 496 latents -> bucket 1000:
    prefill + 16 latent-growth, 8 prefix-growth (boundary) and 8
    sliding-window steps. Every prompt is at least ``num_latents`` long, so
    bucketing is token-exact.
    """
    rng = torch.Generator().manual_seed(7)
    groups = [
        (gen_mod.GenerationConfig(max_new_tokens=32, num_latents=64), [64, 200, 333, 480]),
        (gen_mod.GenerationConfig(max_new_tokens=32, num_latents=496), [520, 700, 850, 900]),
    ]
    table = buckets.BucketTable(prompt_lens=(512, 1000), batch_sizes=(4,))
    return table, [
        (c, [torch.randint(1, vocab_size, (n,), generator=rng).numpy() for n in lens])
        for c, lens in groups
    ]


def serve_phase(torch, flash, gen_mod, engine_mod, model, table, work, phase: str = "serve") -> dict:
    """The bucket engine over ``work`` (``[(config, prompts), ...]``) against
    per-request ``generate()``, in fp32. Returns the run's K1 launches (calls,
    per route, device kernels) and the ``generate()`` references."""
    engine = engine_mod.ServingEngine(model, table=table)

    reset_counts(flash)  # count the main path's launches only
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    served = [engine.serve(prompts, c) for c, prompts in work]
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = flash.flash_attention.launches
    routes = dict(flash.flash_attention.route_launches)
    kernel_launches = flash.flash_attention.kernel_launches

    tokens = sum(c.max_new_tokens * len(prompts) for c, prompts in work)
    requests = sum(len(prompts) for _, prompts in work)
    stats = engine.stats()
    refs = [[gen_mod.generate(model, p[None], c)[0].cpu().numpy() for p in prompts] for c, prompts in work]
    mismatches = sum(int((ref != row).any()) for g_rows, g_refs in zip(served, refs)
                     for row, ref in zip(g_rows, g_refs))
    emit(phase, requests=stats["completed"], tokens=tokens, wall_s=wall_s,
         tokens_per_s=tokens / wall_s, ttft_ms_p50=stats["ttft_ms"]["p50"],
         device_execute_ms=engine.samples["device_execute_ms"], batches=stats["batches"],
         k1_launches=launches, k1_launches_per_token=launches / tokens, k1_route_launches=routes,
         k1_kernel_launches=kernel_launches, per_request_generate_mismatches=mismatches, compute_dtype="float32")
    # fp32 serving runs K1's split route (decode attends) and tf32x3 route
    # (prefill), and no other
    if (stats["completed"] != requests or not (routes["split"] > 0 and routes["tf32x3"] > 0)
            or routes["split"] + routes["tf32x3"] != launches or mismatches):
        raise AssertionError(f"{phase}: completed {stats['completed']} of {requests}, K1 launches {routes}, "
                             f"mismatching requests {mismatches}")
    return {"k1": launches, "k1_routes": routes, "k1_kernels": kernel_launches, "refs": refs}


# K4's cases: (name, q_len, lengths), block size 16, 64 pages a row
K4_CASES = (
    ("decode", 1, [1023, 700, 300, 40, 1, 0, 512, 17]),          # tail pages unmapped; row 5 idle
    ("decode7", 7, [1023, 700, 300, 5, 1, 0, 512, 17]),          # 7 queries a row (split takes <= 16):
                                                                  # rows 3 and 4 shorter (8 dead queries)
    ("window", 512, [520, 600, 680, 760, 840, 920, 1000, 1024]),
    ("ragged", 100, [100, 250, 612, 40, 0, 333, 1000, 164]),      # ragged query tiles; row 3 shorter
                                                                  # than q_len (queries 0..59 dead), row 4 idle
    ("slot", 512, [1024, 777, 520, 0]),                           # the slot engine's window step: 4 slots
    ("shared", 512, [520, 680, 840, 1000]),                       # a shared finalize's query rows (the
                                                                  # 512-slot latent segment), tables
                                                                  # aliasing 24 leading pages
    ("finalize", 512, [1000]),                                    # one shared finalize as the engine
                                                                  # calls it: b = 1, 64 blocks
)
# cases whose rows all map the same leading pages (a shared prompt prefix)
K4_SHARED_PAGES = {"shared": 24}
# the kernels' other head dims: the decode and window cases
K4_OTHER_CASES = ("decode", "window")
# K4 at the symbolic-audio model's GiantMIDI shapes (d = 96, 384-page tables
# of 16 tokens = 6144): decode rows of up to 6143 cached keys, and the
# boundary step's window rows of 2048 latents
K4_SAM_CASES = (
    ("decode_sam", 1, [6143, 4000, 2049, 17]),
    ("window_sam", 2048, [2100, 4000, 5000, 6144]),
)
K4_SAM_PAGES = 384
#: K4 per shard: clm-base over ``model=2`` (4 heads a rank), the two slot
#: rows of a data rank of phase 14c's 2x2 mesh
K4_SHARD_CASES = (
    ("decode_shard", 1, [1023, 700]),
    ("window_shard", 512, [1024, 777]),
)
K4_SHARD_HEADS = 4


def k4_expected_route(q_len: int) -> str:
    return "split" if q_len <= 16 else "tc"


def k4_cases(torch, ragged, paged):
    """K4 against its plain version at clm-base's shapes (module docstring),
    through the route the wrapper picks, beside the first (simt) kernel on
    the same inputs (``prev_ms``), itself held to the same gates."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(2)
    bs = 16
    shapes = [(*c, K1_HEAD_DIM, 8) for c in K4_CASES] + [
        (*c, d, 8) for d in K1_OTHER_HEAD_DIMS for c in K4_CASES if c[0] in K4_OTHER_CASES] + [
        (*c, SAM_HEAD_DIM, 8) for c in K4_SAM_CASES] + [
        (*c, K1_HEAD_DIM, K4_SHARD_HEADS) for c in K4_SHARD_CASES]
    cases = []
    for name, q_len, lengths, d, h in shapes:
        main_dim = d == K1_HEAD_DIM
        sam = name.endswith("_sam")
        pages = K4_SAM_PAGES if sam else 64
        with_prev = d in ragged.SIMT_HEAD_DIMS  # the simt kernel keeps 64, 112 and 128
        b = len(lengths)
        lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        shared = K4_SHARED_PAGES.get(name, 0)
        used = [-(-length // bs) - shared for length in lengths]  # each row's own pages
        blocks = (torch.randperm(shared + sum(used), generator=gen, device="cuda") + 1).int()
        table = torch.zeros(b, pages, dtype=torch.int32, device="cuda")  # tail pages: null block
        table[:, :shared] = blocks[:shared]
        start = shared
        for r, u in enumerate(used):
            table[r, shared:shared + u] = blocks[start:start + u]
            start += u
        tokens = (shared + sum(used) + 1) * bs
        pk = torch.randn(tokens, h, d, generator=gen, device="cuda")
        pv = torch.randn(tokens, h, d, generator=gen, device="cuda")
        pk[:bs], pv[:bs] = 1e3, -1e3  # trash in the null block
        pos = torch.arange(pages * bs, device="cuda")
        qi = torch.arange(q_len, device="cuda")[:, None]
        visible = (pos[None, :] + (q_len - 1) - qi)[None] < lens.long()[:, None, None]  # (b, q, n)
        live = visible.any(-1)[:, None, :, None]  # (b, 1, q, 1): queries that see a key
        pairs = int(visible.sum().item()) * h
        # keys K4 must read, each live pool row once (shared pages count once)
        n_live = sum(min(max(length, 0), pages * bs) for length in lengths) - (b - 1) * shared * bs
        flat = paged.flat_position_indices(table, bs, pages * bs)
        expected = k4_expected_route(q_len)
        for layout in ("float32", "bfloat16", "int8"):
            dtype = torch.bfloat16 if layout == "bfloat16" else torch.float32
            q = (torch.randn(b, h, q_len, d, generator=gen, device="cuda") * d**-0.5).to(dtype)
            if layout == "int8":
                pool_k, sk = paged.quantize_kv(pk)
                pool_v, sv = paged.quantize_kv(pv)
                pool_k[:bs], pool_v[:bs] = 119, -77  # garbage bytes under zero scales
                sk[:bs], sv[:bs] = 0.0, 0.0
                pool = (pool_k, pool_v, sk, sv)
            else:
                pool = (pk.to(dtype), pv.to(dtype))

            def kernel(pool_k, pool_v, scale_k=None, scale_v=None):
                return ragged.ragged_paged_attention(q, pool_k, pool_v, table, lens, block_size=bs,
                                                     scale_k=scale_k, scale_v=scale_v)

            def prev(pool_k, pool_v, scale_k=None, scale_v=None):
                return ragged._k4_launch("simt", q, pool_k, pool_v, table, lens, bs, scale_k, scale_v)

            def plain(pool_k, pool_v, scale_k=None, scale_v=None):
                return ragged.ragged_paged_attention_reference(
                    q, pool_k, pool_v, table, lens, block_size=bs, scale_k=scale_k, scale_v=scale_v)

            def gather_sdpa(pool_k, pool_v, scale_k=None, scale_v=None):
                k = paged.gather_kv(pool_k, flat, scale_k, dtype)
                v = paged.gather_kv(pool_v, flat, scale_v, dtype)
                return F.scaled_dot_product_attention(q, k, v, attn_mask=visible[:, None], scale=1.0)

            before = dict(ragged.ragged_paged_attention.route_launches)
            o = kernel(*pool)
            route = next(r for r, n in ragged.ragged_paged_attention.route_launches.items() if n != before[r])
            o_prev, ref = prev(*pool) if with_prev else None, plain(*pool)
            torch.cuda.synchronize()
            tol = K4_TOL[layout]
            checks = {}
            for who, out in (("kernel", o), ("prev", o_prev)):
                if out is None:
                    continue
                checks[who] = dict(
                    err=(out.float() - ref.float()).abs().max().item(),
                    dead_zero=bool((out[~live.expand_as(out)] == 0).all().item()),
                    finite=bool(torch.isfinite(out).all().item()))
            del o_prev
            for who, c in checks.items():
                if not (c["err"] <= tol and c["dead_zero"] and c["finite"]):
                    raise AssertionError(f"K4 {who} {name} d={d} {layout} ({route}): max|d| {c['err']} "
                                         f"(tol {tol}), idle rows and dead queries zero {c['dead_zero']}, "
                                         f"finite {c['finite']}")
            if route != expected:
                raise AssertionError(f"K4 {name} d={d} {layout}: route {route}, expected {expected}")
            iters = (200 if q_len == 1 else 50) if main_dim else (50 if q_len == 1 else 15)
            plain_iters = 10 if main_dim else 3
            if sam:
                iters, plain_iters = SAM_ITERS
            del o, ref
            cold_kernel, copies = l2_cold(kernel, *pool)
            ms = device_ms(cold_kernel, iters)
            prev_ms = device_ms(l2_cold(prev, *pool)[0], iters) if with_prev else None
            plain_ms = device_ms(l2_cold(plain, *pool)[0], plain_iters)
            gather_sdpa_ms = device_ms(l2_cold(gather_sdpa, *pool)[0], iters)
            del cold_kernel
            torch.cuda.empty_cache()
            int8 = len(pool) == 4
            nbytes = (2 * q.numel() * q.element_size() + 2 * n_live * h * d * pool[0].element_size()
                      + (2 * n_live * h * 4 if int8 else 0) + table.numel() * 4 + lens.numel() * 4)
            flops = 4 * d * pairs  # q.k and p.v over the (query, key) pairs this data makes visible
            tname = str(dtype).split(".")[-1]  # the products run in q's type
            bytes_s, ops_s = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[tname]
            case = dict(
                case=name, layout=layout, route=route, b=b, h=h, q_len=q_len, d=d, block_size=bs,
                lengths=lengths, shared_pages=shared, max_abs_err=checks["kernel"]["err"], tol=tol,
                idle_rows_dead_queries_zero=checks["kernel"]["dead_zero"],
                dead_queries=int((~live).sum().item()),
                ms=ms, prev_ms=prev_ms, prev_route="simt" if with_prev else None,
                prev_max_abs_err=checks["prev"]["err"] if with_prev else None,
                plain_ms=plain_ms, gather_sdpa_ms=gather_sdpa_ms, library_ms=None,
                input_copies=copies, iters=iters,
                library_note="no single PyTorch call reads a block table",
            )
            if route == "tc":
                # the tensor cores' fp32-accurate rate: a third of TF32's for
                # fp32 and int8 pools, bf16's for bf16; the CUDA cores' bound
                # stays beside it so rows compare with the simt kernel's
                case.update(bound_simt_ms=max(bytes_s, ops_s) * 1e3,
                            bound_simt_by="bytes" if bytes_s >= ops_s else "operations")
                ops_s = flops / PEAK_FLOPS["bfloat16"] if layout == "bfloat16" else 3 * flops / TF32_FLOPS
            case.update(bound_ms=max(bytes_s, ops_s) * 1e3,
                        bound_by="bytes" if bytes_s >= ops_s else "operations",
                        bytes=nbytes, flops=flops)
            emit("k4", **case)
            cases.append(case)
    return cases


def k4_refusals(torch, ragged) -> None:
    """K4's split and tc routes refuse a query, and a pool, on a base off a
    16-byte boundary: the wrapper raises ``ValueError`` and counts no
    launch; at head dims 112 and 96."""
    bs = 16
    table = torch.tensor([[1, 2]], dtype=torch.int32, device="cuda")
    lengths = torch.tensor([20], dtype=torch.int32, device="cuda")
    seen = {}

    def counts():
        return ragged.ragged_paged_attention.launches, dict(ragged.ragged_paged_attention.route_launches)

    for d, (route, q_len, dtype) in itertools.product(
            (K1_HEAD_DIM, SAM_HEAD_DIM), (("split", 1, torch.float32), ("tc", 64, torch.bfloat16))):
        q = torch.randn(1, 8, q_len, d, device="cuda").to(dtype)
        pool = torch.randn(3 * bs, 8, d, device="cuda").to(dtype)
        # contiguous, one element (2 or 4 bytes) off the allocation's base
        off_q = torch.randn(q.numel() + 1, device="cuda").to(dtype)[1:].view_as(q)
        off_pool = torch.randn(pool.numel() + 1, device="cuda").to(dtype)[1:].view_as(pool)
        for what, args in (("q", (off_q, pool, pool)), ("pool", (q, off_pool, off_pool))):
            before = counts()
            message = None
            try:
                ragged.ragged_paged_attention(*args, table, lengths, block_size=bs)
            except ValueError as e:
                message = str(e)
            seen[f"{route} {what} d={d}"] = dict(picked=ragged._k4_route(q_len, dtype),
                                                 message=message, counted=counts() != before)
    emit("k4_refusal", routes=seen)
    for key, r in seen.items():
        if (r["picked"] != key.split()[0] or r["message"] is None or "16-byte" not in r["message"]
                or r["counted"]):
            raise AssertionError(f"K4 {key} did not refuse a misaligned base: {r}")


def slot_serve_workload(torch, gen_mod, vocab_size: int):
    """The slot-serve phase's 12 requests: ``(config, prompts, max_new)``."""
    rng = torch.Generator().manual_seed(11)
    lens = [500, 530, 600, 640, 700, 720, 780, 800, 850, 880, 900, 960]
    news = [(16, 32, 48)[i % 3] for i in range(len(lens))]
    prompts = [torch.randint(1, vocab_size, (n,), generator=rng).numpy() for n in lens]
    return gen_mod.GenerationConfig(num_latents=496), prompts, news


def _top2_gap(torch, gen_mod, model, cfg, prompt, tokens, t: int) -> float:
    """The reference's top-2 logit gap before token ``t`` (full recompute)."""
    n, max_latents = model.max_seq_len, model.max_latents
    ctx = list(prompt) + list(tokens[:t])
    window = torch.zeros((1, n), dtype=torch.long, device=model.device)
    window[0, n - len(ctx):] = torch.tensor(ctx, device=model.device)
    pad = torch.tensor([n - len(ctx)], device=model.device)
    with torch.no_grad():
        logits = gen_mod._decode_forward(model, window, pad, min(cfg.num_latents + t, max_latents))
    top = logits[0].float().topk(2).values
    return (top[0] - top[1]).item()


def _divergences(torch, gen_mod, model, rows, refs, prompts, configs, failures) -> list:
    """Each row's first token that differs from its ``generate()`` reference,
    with the reference's top-2 gap there; a gap of ``NEAR_TIE`` or more is a
    failure."""
    out = []
    for i, (row, ref) in enumerate(zip(rows, refs)):
        diff = [t for t in range(len(ref)) if row[t] != ref[t]]
        if diff:
            t = diff[0]
            gap = _top2_gap(torch, gen_mod, model, configs[i], prompts[i], ref, t)
            out.append({"request": i, "token": t, "top2_gap": gap})
            if gap >= NEAR_TIE:
                failures.append(f"request {i} diverges at token {t}, top-2 gap {gap}")
    return out


def run_tracking_residents(engine) -> int:
    """Step ``engine`` until idle; returns the most residents one step held."""
    peak = 0
    while engine.pending():
        engine.step()
        peak = max(peak, len(engine._active()))
    return peak


def slot_serve_phase(torch, flash, ragged, gen_mod, slots_mod, model, table, workload,
                     phase: str = "slot_serve"):
    """Phase 7: ``workload`` (``(config, prompts, max_new)``) through the slot
    engine, 4 slots, once per KV layout, in fp32. Returns ``(launches,
    reuse)``: each layout's launches and step counts, and what the later
    slot phases reuse (the model, the workload, its ``generate()``
    references and the served rows)."""
    import dataclasses

    gcfg, prompts, news = workload
    configs = [dataclasses.replace(gcfg, max_new_tokens=k) for k in news]
    refs = [gen_mod.generate(model, p[None], c)[0].cpu().numpy() for p, c in zip(prompts, configs)]
    tokens = sum(news)
    launches, served = {}, {}
    for layout in ("dense", "paged", "paged_int8"):
        engine = slots_mod.SlotServingEngine(model, gcfg, table, slots=4, kv_layout=layout)
        reset_counts(flash)  # count this path's launches only
        reset_k4_counts(ragged)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reqs = [engine.submit(p, c) for p, c in zip(prompts, configs)]
        peak = run_tracking_residents(engine)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        k1, k4 = flash.flash_attention.launches, ragged.ragged_paged_attention.launches
        k4_routes = dict(ragged.ragged_paged_attention.route_launches)
        launches[layout] = {"tokens_per_s": tokens / wall_s, "peak_residents": peak,
                            "k1": k1, "k4": k4, "k1_routes": dict(flash.flash_attention.route_launches),
                            "k1_kernels": flash.flash_attention.kernel_launches, "k4_routes": k4_routes,
                            "k4_kernels": ragged.ragged_paged_attention.kernel_launches}
        stats = engine.stats()
        launches[layout]["boundary_steps"] = stats["boundary_steps"]
        rows = [r.result for r in reqs]
        served[layout] = rows
        pool = stats.get("kv_pool", {})
        line = dict(
            layout=layout, requests=stats["completed"], tokens=tokens, wall_s=wall_s,
            tokens_per_s=tokens / wall_s, ttft_ms_p50=stats["ttft_ms"]["p50"],
            decode_step_ms_p50=stats["decode_step_ms"]["p50"], decode_steps=stats["decode_steps"],
            boundary_steps=stats["boundary_steps"], prefills=stats["prefills"],
            k1_launches=k1, k4_launches=k4, k1_launches_per_token=k1 / tokens,
            k1_route_launches=launches[layout]["k1_routes"],
            k1_kernel_launches=launches[layout]["k1_kernels"],
            k4_launches_per_token=k4 / tokens, k4_route_launches=k4_routes,
            k4_kernel_launches=launches[layout]["k4_kernels"], pool_in_use=pool.get("in_use"),
            pool_leaked=pool.get("leaked"), pool_high_water=pool.get("high_water"),
            k4_steps=pool.get("ragged_kernel_steps"), peak_residents=peak,
            compute_dtype="float32",
        )
        failures = []
        if stats["completed"] != len(prompts):
            failures.append(f"completed {stats['completed']} of {len(prompts)}")
        if (k4 > 0) != (layout != "dense"):
            failures.append(f"K4 launches {k4} under {layout}")
        if layout != "dense" and (k4_routes["simt"] or not k4_routes["split"] or not k4_routes["tc"]):
            failures.append(f"K4 routes {k4_routes}: decode rows should take split, window rows tc, "
                            "never simt")
        k1_routes = launches[layout]["k1_routes"]
        if k1_routes["tf32x3"] == 0 or k1_routes["split"] + k1_routes["tf32x3"] != k1:
            failures.append(f"K1 routes {k1_routes}: fp32 tiles should take tf32x3, decode rows split, "
                            "nothing else")
        if layout != "dense" and (pool["in_use"] != 0 or pool["leaked"] != 0):
            failures.append(f"pool in_use {pool['in_use']}, leaked {pool['leaked']}")
        if layout != "dense" and pool["ragged_kernel_steps"] != stats["decode_steps"]:
            failures.append(f"{pool['ragged_kernel_steps']} K4 steps of {stats['decode_steps']}")
        if layout == "paged_int8":
            same = sum(int((a == b).sum()) for a, b in zip(rows, served["paged"]))
            line["token_agreement_with_paged"] = same / tokens
        else:
            line["divergences_vs_generate"] = _divergences(torch, gen_mod, model, rows, refs,
                                                               prompts, configs, failures)
        emit(phase, **line)
        if failures:
            raise AssertionError(f"{phase} {layout}: " + "; ".join(failures))
        del engine
        torch.cuda.empty_cache()
    reuse = dict(model=model, gcfg=gcfg, prompts=prompts, configs=configs, refs=refs, rows=served)
    return launches, reuse


# the slot-prefix phase: one shared system prompt of 24 pages of 16 tokens,
# then each request's own suffix, to the slot-serve phase's prompt lengths;
# long prompts first, so the first (900) misses and is chunked and the ones
# queued behind the chunk lane hit once it publishes, and 960 is admitted
# while three residents decode
SLOT_PREFIX_SYSTEM = 384
SLOT_PREFIX_LENS = (900, 880, 850, 800, 960, 780, 720, 700, 640, 600, 530, 500)
SLOT_PREFIX_CHUNK = 128
SLOT_PREFIX_WATCH = 960


def slot_prefix_workload(torch, gen_mod, vocab_size: int):
    """The slot-prefix phase's 12 requests: ``(config, prompts, max_new)``."""
    import numpy as np

    rng = torch.Generator().manual_seed(12)
    system = torch.randint(1, vocab_size, (SLOT_PREFIX_SYSTEM,), generator=rng).numpy()
    prompts = [np.concatenate([system, torch.randint(1, vocab_size, (n - SLOT_PREFIX_SYSTEM,),
                                                     generator=rng).numpy()])
               for n in SLOT_PREFIX_LENS]
    news = [(16, 32, 48)[i % 3] for i in range(len(prompts))]
    return gen_mod.GenerationConfig(num_latents=496), prompts, news


def drive_slots(engine, watch):
    """Step ``engine`` until idle. Returns ``(ttft_ms, admit_ms, gaps_ms)``:
    each request's time to first token and from its admission's start to
    its first token, by request id, and the residents' inter-token times in
    the steps that ran ``watch``'s admission."""
    ttft, admit, gaps = {}, {}, []
    itl = engine.samples["inter_token_ms"]
    while engine.pending():
        admitting = engine._admitting is not None and engine._admitting.req is watch
        queued = watch.started_at is None
        seen = len(itl)
        engine.step()
        if admitting or (queued and watch.started_at is not None):
            gaps.extend(itl[seen:])
        for entry in engine._slots:  # max_new >= 16: no request retires at its first token
            if entry is not None and entry.emitted and entry.req.request_id not in ttft:
                ttft[entry.req.request_id] = (entry.last_token_at - entry.req.submitted_at) * 1e3
                admit[entry.req.request_id] = (entry.last_token_at - entry.req.started_at) * 1e3
    return ttft, admit, gaps


def _p50(values):
    values = sorted(values)
    return values[len(values) // 2] if values else None


def slot_prefix_phase(torch, flash, ragged, gen_mod, slots_mod, buckets, model):
    """Chunked prefill and prefix sharing in the slot engine (module
    docstring, phase 8), over phase 7's model. Returns ``(launches,
    reuse)``: each layout's launches, and the workload with its
    ``generate()`` references for the slot-preempt phase."""
    import dataclasses

    gcfg, prompts, news = slot_prefix_workload(torch, gen_mod, model.config.vocab_size)
    configs = [dataclasses.replace(gcfg, max_new_tokens=k) for k in news]
    table = buckets.BucketTable(prompt_lens=SLOT_BUCKETS, batch_sizes=(1,))
    refs = [gen_mod.generate(model, p[None], c)[0].cpu().numpy() for p, c in zip(prompts, configs)]
    watch = SLOT_PREFIX_LENS.index(SLOT_PREFIX_WATCH)
    tokens = sum(news)
    served, out = {}, {}
    for layout in ("dense", "paged", "paged_int8"):
        prefix_cache = None if layout == "dense" else "on"
        line, failures = {"layout": layout, "prefix_cache": prefix_cache or "off"}, []
        runs = [("chunked", SLOT_PREFIX_CHUNK, prefix_cache), ("unchunked", None, prefix_cache)]
        if layout == "paged_int8":  # int8's own rounding, apart from sharing's: the requests unshared
            runs.append(("unshared", SLOT_PREFIX_CHUNK, None))
        for key, chunk, cache in runs:
            engine = slots_mod.SlotServingEngine(model, gcfg, table, slots=4, kv_layout=layout,
                                                 prefill_chunk=chunk, prefix_cache=cache)
            hits, map_shared = set(), engine._map_shared_prefix

            def note_hit(req, slot, plan, hits=hits, map_shared=map_shared):
                hits.add(req.request_id)
                return map_shared(req, slot, plan)

            engine._map_shared_prefix = note_hit
            reset_counts(flash)
            reset_k4_counts(ragged)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            reqs = [engine.submit(p, c) for p, c in zip(prompts, configs)]
            ttft, admit, gaps = drive_slots(engine, reqs[watch])
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            stats = engine.stats()
            if stats["completed"] != len(prompts):
                failures.append(f"{key}: completed {stats['completed']} of {len(prompts)}")
            if key == "unshared":
                same = sum(int((r.result == b).sum()) for r, b in zip(reqs, served[layout]))
                line["token_agreement_shared_vs_unshared"] = same / tokens
                del engine
                continue
            line[f"{key}_resident_itl_ms_max_during_{SLOT_PREFIX_WATCH}_admission"] = max(gaps, default=None)
            line[f"{key}_residents_during_{SLOT_PREFIX_WATCH}_admission"] = bool(gaps)
            if key == "unchunked":
                line["unchunked_tokens_per_s"] = tokens / wall_s
                del engine
                continue
            k1, k4 = flash.flash_attention.launches, ragged.ragged_paged_attention.launches
            k1_routes = dict(flash.flash_attention.route_launches)
            k4_routes = dict(ragged.ragged_paged_attention.route_launches)
            rows = [r.result for r in reqs]
            served[layout] = rows
            pool, prefix = stats.get("kv_pool", {}), stats.get("prefix_cache", {})
            line.update(
                requests=stats["completed"], tokens=tokens, wall_s=wall_s, tokens_per_s=tokens / wall_s,
                ttft_ms_p50=stats["ttft_ms"]["p50"],
                ttft_ms_p50_hits=_p50([ms for i, ms in ttft.items() if i in hits]),
                ttft_ms_p50_misses=_p50([ms for i, ms in ttft.items() if i not in hits]),
                admit_to_first_token_ms_p50_hits=_p50([ms for i, ms in admit.items() if i in hits]),
                admit_to_first_token_ms_p50_misses=_p50([ms for i, ms in admit.items() if i not in hits]),
                decode_steps=stats["decode_steps"], boundary_steps=stats["boundary_steps"],
                prefills=stats["prefills"], prefill_chunks=stats["prefill_chunks"],
                prefill_chunk_ms_p50=stats["prefill_chunk_ms"]["p50"],
                k1_launches=k1, k1_route_launches=k1_routes, k4_launches=k4, k4_route_launches=k4_routes,
                k4_kernel_launches=ragged.ragged_paged_attention.kernel_launches,
                compute_dtype="float32",
            )
            if stats["prefill_chunks"] <= 0:
                failures.append("no prefill chunk ran")
            if (k4 > 0) != (layout != "dense"):
                failures.append(f"K4 launches {k4} under {layout}")
            if k1_routes["simt"] or k4_routes["simt"] or not k1_routes["tf32x3"]:
                failures.append(f"K1 routes {k1_routes}, K4 routes {k4_routes}: fp32 tiles should take "
                                "tf32x3, never simt")
            if layout != "dense":
                n_hits, misses = prefix["hits"], prefix["misses"]
                tc_shared = k4_routes["tc"] - stats["boundary_steps"]
                line.update(
                    hits=n_hits, misses=misses, hit_ratio=prefix["hit_ratio"],
                    shared_tokens=prefix["shared_tokens"], shared_blocks=prefix["shared_blocks"],
                    cow_copies=prefix["cow_copies"], published=prefix["published"],
                    evicted=prefix["evicted"], cached_blocks=prefix["cached_blocks"],
                    k4_tc_per_shared_finalize=tc_shared / max(1, n_hits),
                    pool_in_use=pool["in_use"], pool_leaked=pool["leaked"],
                    pool_high_water=pool["high_water"],
                )
                if n_hits < 1 or n_hits + misses != len(prompts) or len(hits) != n_hits:
                    failures.append(f"prefix hits {n_hits} ({len(hits)} seen), misses {misses}")
                if tc_shared < n_hits:
                    failures.append(f"K4 tc launches {k4_routes['tc']} less boundary steps "
                                    f"{stats['boundary_steps']} < hits {n_hits}")
                if pool["leaked"] or pool["in_use"] != prefix["cached_blocks"]:
                    failures.append(f"pool in_use {pool['in_use']}, leaked {pool['leaked']}, cached "
                                    f"{prefix['cached_blocks']}")
                engine._prefix_index.flush(engine._pool)
                line["pool_in_use_after_flush"] = engine._pool.in_use
                if engine._pool.in_use or engine._pool.leaked():
                    failures.append(f"pool in_use {engine._pool.in_use} after the index's flush")
            if layout == "paged_int8":
                same = sum(int((a == b).sum()) for a, b in zip(rows, served["paged"]))
                line["token_agreement_with_paged"] = same / tokens
            else:
                line["divergences_vs_generate"] = _divergences(torch, gen_mod, model, rows, refs,
                                                                   prompts, configs, failures)
            out[layout] = {"k4": k4, "k4_routes": k4_routes,
                           "k4_kernels": ragged.ragged_paged_attention.kernel_launches}
            del engine
        emit("slot_prefix", **line)
        if failures:
            raise AssertionError(f"slot prefix {layout}: " + "; ".join(failures))
        torch.cuda.empty_cache()
    return out, dict(gcfg=gcfg, prompts=prompts, configs=configs, refs=refs)


# the slot-preempt phase: a pool of five eighths of the dense 4 x 64 pages,
# lazy admission on prompt pages alone; every third request interactive
SLOT_PREEMPT_BLOCKS = 160
#: decode steps after the batch tier's submission at which the interactive
#: requests arrive (while batch residents hold the pool)
SLOT_PREEMPT_LATE_STEPS = 8
#: (run, kv layout, preemption, workload): phase 7's prompts, or phase 8's
#: shared-system-prompt ones with chunked prefill and prefix sharing
SLOT_PREEMPT_RUNS = (
    ("paged_recompute", "paged", "recompute", "serve"),
    ("paged_swap", "paged", "swap", "serve"),
    ("paged_auto", "paged", "auto", "serve"),
    ("paged_int8_swap", "paged_int8", "swap", "serve"),
    ("paged_swap_shared", "paged", "swap", "shared"),
)


def preempt_tags(n: int) -> list:
    """Every third request interactive (priority 1), the rest batch (0);
    tenants alternate ``a`` and ``b``."""
    return [dict(priority=int(i % 3 == 0), tenant="ab"[i % 2]) for i in range(n)]


def drive_preempt(engine, prompts, configs, tags, late_steps: int = SLOT_PREEMPT_LATE_STEPS):
    """Submit the batch-tier requests, step ``late_steps`` times, submit the
    interactive ones, and step until idle. Returns ``(reqs, first_token_at,
    peak, admission_preemptions)``: the requests in workload order, the first
    instant each had a token (a replay's later first token does not count: a
    stream has it already), the most residents one step held, and the
    preemptions the admission gate made (an interactive head evicting a batch
    resident)."""
    admission = [0]
    lower = engine._preempt_lower_tier

    def counted(head):
        hit = lower(head)
        admission[0] += int(hit)
        return hit

    engine._preempt_lower_tier = counted
    reqs = [None] * len(prompts)

    def submit(tier):
        for i, (p, c, t) in enumerate(zip(prompts, configs, tags)):
            if t["priority"] == tier:
                reqs[i] = engine.submit(p, c, **t)

    submit(0)
    first, peak, steps = {}, 0, 0
    while engine.pending() or steps <= late_steps:
        if steps == late_steps:
            submit(1)
        steps += 1
        engine.step()
        active = engine._active()
        peak = max(peak, len(active))
        for entry in active:
            if entry.emitted and entry.req.request_id not in first:
                first[entry.req.request_id] = entry.last_token_at
    return reqs, first, peak, admission[0]


def slot_preempt_phase(torch, flash, ragged, gen_mod, slots_mod, buckets, serve, shared, unpressured,
                       device: str = "cuda", kv_blocks: int = SLOT_PREEMPT_BLOCKS):
    """Preemption in the slot engine (module docstring, phase 9), over phase
    7's model and references (``serve``, and ``shared`` from phase 8);
    ``unpressured`` is phase 7's paged run. Returns each run's K4 launches."""
    model = serve["model"]
    on_card = device == "cuda"
    table = buckets.BucketTable(prompt_lens=SLOT_BUCKETS, batch_sizes=(1,))
    out = {}
    for name, layout, mode, workload in SLOT_PREEMPT_RUNS:
        load = serve if workload == "serve" else shared
        prompts, configs, refs = load["prompts"], load["configs"], load["refs"]
        tags = preempt_tags(len(prompts))
        chunk, cache = (SLOT_PREFIX_CHUNK, "on") if workload == "shared" else (None, None)
        engine = slots_mod.SlotServingEngine(
            model, load["gcfg"], table, slots=4, kv_layout=layout, kv_blocks=kv_blocks,
            preemption=mode, admit_headroom_blocks=0, prefill_chunk=chunk, prefix_cache=cache,
            device=device)
        reset_counts(flash)  # count this run's launches only
        reset_k4_counts(ragged)
        if on_card:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        reqs, first, peak, admission = drive_preempt(engine, prompts, configs, tags)
        if on_card:
            torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        tokens = sum(c.max_new_tokens for c in configs)
        k1_routes = dict(flash.flash_attention.route_launches)
        k4_routes = dict(ragged.ragged_paged_attention.route_launches)
        stats = engine.stats()
        pre, pool = stats["preemption"], stats["kv_pool"]
        pm = engine.postmortems()
        swapped = [r for r in engine._postmortems if r["mode"] == "swap"]
        out_ms, in_ms = engine.samples["swap_out_ms"], engine.samples["swap_in_ms"]
        moved = sum(r["payload_bytes"] for r in swapped)
        ttft = {tier: _p50([(first[r.request_id] - r.submitted_at) * 1e3 for r, t in zip(reqs, tags)
                            if t["priority"] == tier and r.request_id in first]) for tier in (1, 0)}
        line = dict(
            run=name, layout=layout, preemption=mode, workload=workload, kv_blocks=kv_blocks,
            prefill_chunk=chunk, prefix_cache=cache or "off", requests=stats["completed"],
            tokens=tokens, wall_s=wall_s, tokens_per_s=tokens / wall_s, peak_residents=peak,
            unpressured_tokens_per_s=unpressured["tokens_per_s"],
            unpressured_peak_residents=unpressured["peak_residents"],
            preemptions=pre["preemptions"], readmissions=pre["readmissions"],
            admission_preemptions=admission, decode_preemptions=pre["preemptions"] - admission,
            by_tier=pre["by_tier"], by_tenant=pre["by_tenant"], swaps=pre["swaps"],
            swap_restores=pre["swap_restores"], swap_bytes=pre["swap_bytes"],
            swapped_waiting=pre["swapped_waiting"], swap_out_ms_p50=_p50(out_ms),
            swap_in_ms_p50=_p50(in_ms), swap_out_ms=out_ms, swap_in_ms=in_ms,
            swap_out_gbps=moved / sum(out_ms) / 1e6 if out_ms else None,
            swap_in_gbps=moved / sum(in_ms) / 1e6 if in_ms and len(in_ms) == len(out_ms) else None,
            swap_link_gbps_model=pre["swap_link_gbps"],
            postmortems={k: pm[k] for k in ("count", "swapped", "tokens_discarded", "pages_released",
                                             "victim_bytes", "recompute_est_ms", "swap_est_ms",
                                             "swap_measured_ms", "swap_advantage_ms")},
            victims_swapped=len(swapped),
            victim_bytes_priced_mean=_mean([r["victim_bytes"] for r in swapped]),
            payload_bytes_mean=_mean([r["payload_bytes"] for r in swapped]),
            decode_step_ms_p50=stats["decode_step_ms"]["p50"], decode_steps=stats["decode_steps"],
            boundary_steps=stats["boundary_steps"], prefills=stats["prefills"],
            prefill_chunks=stats["prefill_chunks"], ttft_ms_p50_tier_1=ttft[1], ttft_ms_p50_tier_0=ttft[0],
            k1_route_launches=k1_routes, k4_launches=ragged.ragged_paged_attention.launches,
            k4_route_launches=k4_routes, pool_in_use=pool["in_use"], pool_leaked=pool["leaked"],
            pool_high_water=pool["high_water"], frees_by_cause=pool["frees_by_cause"],
        )
        if swapped:
            line["payload_over_priced"] = line["payload_bytes_mean"] / line["victim_bytes_priced_mean"]
        failures = []
        if stats["completed"] != len(prompts):
            failures.append(f"completed {stats['completed']} of {len(prompts)}")
        if pre["preemptions"] < 1 or pre["readmissions"] < 1:
            failures.append(f"preemptions {pre['preemptions']}, readmissions {pre['readmissions']}")
        if mode == "swap" and (pre["swaps"] < 1 or pre["swap_restores"] != pre["swaps"]
                               or pre["swapped_waiting"]):
            failures.append(f"swaps {pre['swaps']}, restores {pre['swap_restores']}, waiting "
                            f"{pre['swapped_waiting']}")
        if on_card and (k4_routes["simt"] or not k4_routes["split"] or not k4_routes["tc"]
                        or k1_routes["simt"]):
            failures.append(f"K4 routes {k4_routes}, K1 routes {k1_routes}: K4 on split and tc only, "
                            "K1 never on simt")
        if workload == "shared":
            line.update(hits=stats["prefix_cache"]["hits"],
                        cached_blocks=stats["prefix_cache"]["cached_blocks"])
            if pool["leaked"] or pool["in_use"] != stats["prefix_cache"]["cached_blocks"]:
                failures.append(f"pool in_use {pool['in_use']}, leaked {pool['leaked']}, cached "
                                f"{stats['prefix_cache']['cached_blocks']}")
            engine._prefix_index.flush(engine._pool)
            line["pool_in_use_after_flush"] = engine._pool.in_use
        if engine._pool.in_use or engine._pool.leaked():
            failures.append(f"pool in_use {engine._pool.in_use}, leaked {engine._pool.leaked()}")
        rows = [r.result for r in reqs]
        if layout == "paged_int8":
            same = sum(int((a == b).sum()) for a, b in zip(rows, refs))
            line["token_agreement_with_fp32_refs"] = same / tokens
        else:
            line["divergences_vs_generate"] = _divergences(torch, gen_mod, model, rows, refs,
                                                               prompts, configs, failures)
        emit("slot_preempt", **line)
        if failures:
            raise AssertionError(f"slot preempt {name}: " + "; ".join(failures))
        out[name] = {"k4": ragged.ragged_paged_attention.launches, "k4_routes": k4_routes,
                     "k4_kernels": ragged.ragged_paged_attention.kernel_launches}
        del engine
        if on_card:
            torch.cuda.empty_cache()
    return out


#: (run, kv layout, speculation, preemption): phase 7's traffic; the swap
#: run over phase 9's pool with its tiers and late arrivals
#: (a round reads no KV cache, so one layout without preemption: paged)
SLOT_SPEC_RUNS = (
    ("k4d2_paged", "paged", "k4d2", None),
    ("k2d1_paged_swap", "paged", "k2d1", "swap"),
)
#: phase 7's requests that the standalone speculative_generate runs
SLOT_SPEC_STANDALONE = 4
#: phase 7's first requests that the engine runs without preemption serve
#: (the preemption run takes all 12, phase 9's pressure)
SLOT_SPEC_PLAIN_REQUESTS = 6


def spec_standalone(torch, gen_mod, spec_mod, serve) -> list:
    """(a) ``speculative_generate`` over phase 7's first requests: with a
    full-depth draft (the model itself), every drafted token must be
    accepted but at a near-tie (the verify lane's top logit less the
    draft's < ``NEAR_TIE``: the draft runs at b rows, the verify at
    b·(k+1)); then with a 2-layer draft. Tokens equal ``generate()``."""
    model = serve["model"]
    depth = model.config.num_self_attention_layers
    rounds = []
    accept = spec_mod.accept_prefix

    def recording(lane_logits, cand, steps, min_new, eos):
        n_e, nxt = accept(lane_logits, cand, steps, min_new, eos)
        rounds.append((lane_logits.float(), cand, n_e))
        return n_e, nxt

    lines = []
    spec_mod.accept_prefix = recording
    try:
        for k, d in ((4, depth), (4, 2)):
            failures, near_ties, proposed, accepted = [], [], 0, 0
            rows, t0 = [], time.perf_counter()
            for i in range(SLOT_SPEC_STANDALONE):
                rounds.clear()
                prompt, cfg = serve["prompts"][i], serve["configs"][i]
                rows.append(spec_mod.speculative_generate(
                    model, prompt[None], cfg, spec_mod.SpecConfig(k, d),
                    device=model.device)[0].cpu().numpy())
                for lane_logits, cand, n_e in rounds:
                    n = int(n_e[0])
                    proposed, accepted = proposed + k, accepted + n - 1
                    if d == depth and n < k + 1:
                        lane, draft = lane_logits[0, n - 1], int(cand[0, n])
                        gap = (lane.max() - lane[draft]).item()
                        near_ties.append({"request": i, "lane": n - 1, "gap": gap})
                        if gap >= NEAR_TIE:
                            failures.append(f"request {i}: full-depth draft rejected at lane {n - 1}, "
                                            f"gap {gap}")
            if model.device.type == "cuda":
                torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            divergences = _divergences(torch, gen_mod, model, rows, serve["refs"], serve["prompts"],
                                       serve["configs"], failures)
            tokens = sum(c.max_new_tokens for c in serve["configs"][:SLOT_SPEC_STANDALONE])
            line = dict(part="standalone", spec=f"k{k}d{d}", requests=SLOT_SPEC_STANDALONE,
                        tokens=tokens, wall_s=wall_s, tokens_per_s=tokens / wall_s,
                        proposed=proposed, accepted=accepted,
                        acceptance_rate=accepted / max(1, proposed), near_tie_rejections=near_ties,
                        divergences_vs_generate=divergences)
            emit("slot_spec", **line)
            lines.append(line)
            if failures:
                raise AssertionError(f"slot spec standalone k{k}d{d}: " + "; ".join(failures))
    finally:
        spec_mod.accept_prefix = accept
    return lines


def spec_engine_runs(torch, flash, ragged, gen_mod, spec_mod, slots_mod, buckets, clm, serve,
                     unpressured, kv_blocks: int = SLOT_PREEMPT_BLOCKS) -> dict:
    """(b) ``SlotServingEngine`` with speculation over phase 7's requests
    (``SLOT_SPEC_RUNS``), then one bf16 run beside its fp32 twin. Returns
    each run's launches."""
    model = serve["model"]
    on_card = model.device.type == "cuda"
    table = buckets.BucketTable(prompt_lens=SLOT_BUCKETS, batch_sizes=(1,))
    verify_rows, forward = [], spec_mod._decode_forward

    def counting_forward(mdl, window, pad, m):
        verify_rows.append(int(window.shape[0]))
        return forward(mdl, window, pad, m)

    out, rows_by_run = {}, {}
    runs = [(name, layout, mode, pre, model) for name, layout, mode, pre in SLOT_SPEC_RUNS]
    bf16 = clm.CausalLanguageModel(model.config, dtype=torch.bfloat16, seed=0,
                                   device=model.device).eval()
    runs.append(("k4d2_paged_bf16", "paged", "k4d2", None, bf16))
    spec_mod._decode_forward = counting_forward  # only verify_lanes calls it here
    try:
        for name, layout, mode, pre, mdl in runs:
            n = len(serve["prompts"]) if pre else SLOT_SPEC_PLAIN_REQUESTS
            prompts, configs, refs = serve["prompts"][:n], serve["configs"][:n], serve["refs"][:n]
            tokens = sum(c.max_new_tokens for c in configs)
            kw = dict(kv_blocks=kv_blocks, preemption=pre, admit_headroom_blocks=0) if pre else {}
            engine = slots_mod.SlotServingEngine(mdl, serve["gcfg"], table, slots=4,
                                                 kv_layout=layout, speculation=mode,
                                                 device=mdl.device, **kw)
            k, d = engine._spec.k, engine._spec.draft_layers
            # k drafts of the cross layer and d stack layers, one verify of all
            round_k1 = k * (1 + d) + 1 + mdl.config.num_self_attention_layers
            per_round = {"k1": [], "k4": [], "ms": []}
            spec_round = engine._spec_round

            def timed_round(spec_round=spec_round, per_round=per_round):
                k1, k4 = flash.flash_attention.launches, ragged.ragged_paged_attention.launches
                if on_card:
                    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                    start.record()
                result = spec_round()  # ends in a host read
                if on_card:
                    end.record()
                    end.synchronize()
                    per_round["ms"].append(start.elapsed_time(end))
                per_round["k1"].append(flash.flash_attention.launches - k1)
                per_round["k4"].append(ragged.ragged_paged_attention.launches - k4)
                return result

            engine._spec_round = timed_round
            verify_rows.clear()
            reset_counts(flash)
            reset_k4_counts(ragged)
            if on_card:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            if pre:
                reqs, _, peak, admission = drive_preempt(engine, prompts, configs,
                                                         preempt_tags(len(prompts)))
            else:
                reqs = [engine.submit(p, c) for p, c in zip(prompts, configs)]
                peak, admission = run_tracking_residents(engine), 0
            if on_card:
                torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            stats = engine.stats()
            sp = stats["speculation"]
            k1_routes = dict(flash.flash_attention.route_launches)
            k4_routes = dict(ragged.ragged_paged_attention.route_launches)
            rows = [r.result for r in reqs]
            rows_by_run[name] = rows
            line = dict(
                part="engine", run=name, layout=layout, speculation=mode, preemption=pre or "off",
                compute_dtype=str(mdl.dtype).split(".")[-1], requests=stats["completed"],
                tokens=tokens, wall_s=wall_s, tokens_per_s=tokens / wall_s,
                phase7_tokens_per_s=unpressured[layout]["tokens_per_s"],
                rounds=sp["rounds"], proposed=sp["proposed"], accepted=sp["accepted"],
                emitted=sp["emitted"], acceptance_rate=sp["acceptance_rate"],
                tokens_per_round=sp["tokens_per_round"], peak_residents=peak,
                decode_step_ms_p50=stats["decode_step_ms"]["p50"], prefills=stats["prefills"],
                k1_launches=flash.flash_attention.launches, k1_route_launches=k1_routes,
                k1_launches_per_round=_mean(per_round["k1"]), k1_launches_per_round_expected=round_k1,
                round_ms_mean=_mean(per_round["ms"]),
                round_ms_p50=_p50(per_round["ms"]), verify_rows=sorted(set(verify_rows)),
                k4_launches=ragged.ragged_paged_attention.launches, k4_route_launches=k4_routes,
                k4_launches_in_rounds=sum(per_round["k4"]),
            )
            failures = []
            if stats["completed"] != len(prompts):
                failures.append(f"completed {stats['completed']} of {len(prompts)}")
            if sp["emitted"] != tokens or sp["accepted"] > sp["proposed"]:
                failures.append(f"emitted {sp['emitted']} of {tokens} served, accepted "
                                f"{sp['accepted']} of {sp['proposed']} proposed")
            if on_card and set(per_round["k1"]) != {round_k1}:
                failures.append(f"K1 launches per round {sorted(set(per_round['k1']))}, "
                                f"not {round_k1}")
            if set(verify_rows) != {4 * (k + 1)} or len(verify_rows) != sp["rounds"]:
                failures.append(f"verify calls at rows {sorted(set(verify_rows))} "
                                f"({len(verify_rows)} calls, {sp['rounds']} rounds), not {4 * (k + 1)}")
            if on_card:
                tile = "tf32x3" if mdl.dtype == torch.float32 else "wgmma"
                if k1_routes["simt"] or not k1_routes[tile] or any(
                        k1_routes[r] for r in ("tf32x3", "wgmma") if r != tile):
                    failures.append(f"K1 routes {k1_routes}: {tile} tiles only, never simt")
                if k4_routes["simt"] or line["k4_launches_in_rounds"]:
                    failures.append(f"K4 routes {k4_routes}, {line['k4_launches_in_rounds']} K4 "
                                    "launches inside spec rounds: split/tc only, none in a round")
            if pre:
                pre_stats = stats["preemption"]
                line.update(preemptions=pre_stats["preemptions"], admission_preemptions=admission,
                            readmissions=pre_stats["readmissions"], swaps=pre_stats["swaps"],
                            swap_restores=pre_stats["swap_restores"],
                            swapped_waiting=pre_stats["swapped_waiting"],
                            swap_link_gbps_model=pre_stats["swap_link_gbps"])
                if pre_stats["swap_restores"] != pre_stats["swaps"] or pre_stats["swapped_waiting"]:
                    failures.append(f"swaps {pre_stats['swaps']}, restores "
                                    f"{pre_stats['swap_restores']}, waiting "
                                    f"{pre_stats['swapped_waiting']}")
            if engine._pool is not None:
                line.update(pool_in_use=engine._pool.in_use, pool_leaked=engine._pool.leaked(),
                            pool_high_water=stats["kv_pool"]["high_water"])
                if engine._pool.in_use or engine._pool.leaked():
                    failures.append(f"pool in_use {engine._pool.in_use}, leaked {engine._pool.leaked()}")
            if mdl is bf16:
                twin = rows_by_run["k4d2_paged"]
                line["token_agreement_with_fp32_twin"] = \
                    sum(int((a == b).sum()) for a, b in zip(rows, twin)) / tokens
            else:
                line["divergences_vs_generate"] = _divergences(torch, gen_mod, model, rows, refs,
                                                               prompts, configs, failures)
            emit("slot_spec", **line)
            if failures:
                raise AssertionError(f"slot spec {name}: " + "; ".join(failures))
            out[name] = {"k1": line["k1_launches"], "k1_routes": k1_routes,
                         "k4": line["k4_launches"], "rounds": sp["rounds"]}
            del engine
            if on_card:
                torch.cuda.empty_cache()
    finally:
        spec_mod._decode_forward = forward
    del bf16
    return out


def spec_autotune(torch, gen_mod, strategy_mod, slots_mod, buckets, serve, root: Path) -> dict:
    """(c) A fresh registry file, an engine with every measured axis
    ``"auto"`` and its ``warmup()``: each verdict with its timings. Each
    probe's fence is checked: one of its arms timed again between
    synchronisations (the median of three timed runs: a single host-timed
    run of these few-millisecond arms has read more than 2x off its probe;
    ``PERF.md``) must lie within 2x of the probe's figure. A second engine
    over the file's verdicts must measure nothing."""
    import numpy as np

    model = serve["model"]
    on_card = model.device.type == "cuda"
    table = buckets.BucketTable(prompt_lens=SLOT_BUCKETS, batch_sizes=(1,))
    path = root / "decode_strategy.json"
    path.unlink(missing_ok=True)
    strategy_mod.reset_registry()
    axes = dict(decode_strategy="auto", kv_layout="auto", prefix_cache="auto", speculation="auto")

    def sync():
        if on_card:
            torch.cuda.synchronize()

    engine = slots_mod.SlotServingEngine(model, serve["gcfg"], table, slots=4, device=model.device,
                                         **axes)
    t0 = time.perf_counter()
    steps = engine.warmup()
    warmup_s = time.perf_counter() - t0
    strategy_mod.save_registry(str(path))
    boundary = dict(strategy_mod._REGISTRY[strategy_mod.registry_key(model)])
    kv, spec = strategy_mod.kv_entry(model), strategy_mod.spec_entry(model)
    verdicts = {"boundary": engine.boundary_mode, "kv_layout": engine.kv_layout,
                "prefix_cache": engine.prefix_cache, "speculation": engine.speculation}

    # the fences: one arm of each probe again, between synchronisations
    n = model.max_seq_len
    new = boundary["new_tokens"]
    prompt = np.random.default_rng(0).integers(1, model.config.vocab_size, size=(1, n - new),
                                               dtype=np.int32)
    gcfg = gen_mod.GenerationConfig(max_new_tokens=new, num_latents=model.max_latents)
    runs = {"boundary cached": []}
    for _ in range(3):
        sync()
        t0 = time.perf_counter()
        gen_mod.generate(model, prompt, gcfg, decode_strategy="cached", device=model.device)
        sync()
        runs["boundary cached"].append((time.perf_counter() - t0) / new * 1e3)
    probed = {"boundary cached": boundary["cached_ms_per_token"]}
    probe_table, probe_cfg, probe_prompts, probe_new = strategy_mod._kv_probe_workload(model, 2, 8)
    for key, kw, figure in (("kv_layout dense", dict(kv_layout="dense"), kv["dense_ms_per_token"]),
                            ("speculation off", dict(speculation="off"),
                             spec["timings_ms_per_token"]["off"])):
        runs[key], probed[key] = [], figure
        for _ in range(3):
            arm = slots_mod.SlotServingEngine(model, probe_cfg, probe_table, slots=2,
                                              device=model.device, **kw)
            for p in probe_prompts:
                arm.submit(p)
            sync()
            t0 = time.perf_counter()
            arm.run_until_idle()
            sync()
            runs[key].append((time.perf_counter() - t0) / (2 * probe_new) * 1e3)
    fences = {key: (float(np.median(times)), probed[key]) for key, times in runs.items()}
    failures = [f"{key}: probe {probe} ms a token against {again} timed again (runs {runs[key]})"
                for key, (again, probe) in fences.items()
                if not 0.5 <= probe / max(again, 1e-9) <= 2.0]

    # a second engine over the file measures nothing
    strategy_mod.reset_registry()
    loaded = strategy_mod.load_registry(str(path))
    second = slots_mod.SlotServingEngine(model, serve["gcfg"], table, slots=4, device=model.device,
                                         **axes)
    probes = {"engines": 0, "generate": 0}
    engine_cls, generate = slots_mod.SlotServingEngine, gen_mod.generate

    def counting_engine(*args, **kwargs):
        probes["engines"] += 1
        return engine_cls(*args, **kwargs)

    def counting_generate(*args, **kwargs):
        probes["generate"] += 1
        return generate(*args, **kwargs)

    slots_mod.SlotServingEngine, gen_mod.generate = counting_engine, counting_generate
    try:
        t0 = time.perf_counter()
        second.warmup()
        second_s = time.perf_counter() - t0
    finally:
        slots_mod.SlotServingEngine, gen_mod.generate = engine_cls, generate
    second_verdicts = {"boundary": second.boundary_mode, "kv_layout": second.kv_layout,
                       "prefix_cache": second.prefix_cache, "speculation": second.speculation}
    if probes != {"engines": 0, "generate": 0} or second_verdicts != verdicts:
        failures.append(f"the second engine measured {probes}, verdicts {second_verdicts} "
                        f"against {verdicts}")
    line = dict(part="autotune", verdicts=verdicts, warmup_s=warmup_s, warmup_steps=steps,
                boundary_entry=boundary, kv_entry=kv, spec_entry=spec,
                kv_quant_fallback=engine.counters["kv_quant_fallback_total"],
                fences={k: {"timed_again_ms_per_token": a, "timed_again_runs": runs[k],
                            "probe_ms_per_token": p} for k, (a, p) in fences.items()},
                entries_loaded=loaded, second_warmup_s=second_s, second_probes=probes)
    emit("slot_spec", **line)
    strategy_mod.reset_registry()
    del engine, second
    if on_card:
        torch.cuda.empty_cache()
    if failures:
        raise AssertionError("slot spec autotune: " + "; ".join(failures))
    return line


#: the depth of phases 8-11's model (slot prefix, preempt, spec, sample):
#: clm-base's widths over 4 of its 16 layers
SHALLOW_SERVE_LAYERS = 4


def shallow_serve(torch, clm, gen_mod, serve) -> dict:
    """Phase 7's requests over clm-base's widths at ``SHALLOW_SERVE_LAYERS``
    layers (fp32, random weights from phase 7's seed) with their
    ``generate()`` references: what phases 8-11 run over."""
    cfg = dataclasses.replace(serve["model"].config, num_self_attention_layers=SHALLOW_SERVE_LAYERS)
    model = clm.CausalLanguageModel(cfg, dtype=torch.float32, seed=0).eval()
    refs = [gen_mod.generate(model, p[None], c)[0].cpu().numpy()
            for p, c in zip(serve["prompts"], serve["configs"])]
    emit("shallow_serve", layers=SHALLOW_SERVE_LAYERS, requests=len(refs))
    return dict(serve, model=model, refs=refs, rows=None)


def slot_spec_phase(torch, flash, ragged, gen_mod, spec_mod, strategy_mod, slots_mod, buckets, clm,
                    serve, unpressured, root: Path, kv_blocks: int = SLOT_PREEMPT_BLOCKS) -> dict:
    """Speculative decoding and the measured ``auto`` axes (module
    docstring, phase 10), over phase 7's model, requests and references;
    ``unpressured`` is phase 7's launches (and pace) per layout. Returns
    each engine run's launches."""
    spec_standalone(torch, gen_mod, spec_mod, serve)
    runs = spec_engine_runs(torch, flash, ragged, gen_mod, spec_mod, slots_mod, buckets, clm, serve,
                            unpressured, kv_blocks)
    spec_autotune(torch, gen_mod, strategy_mod, slots_mod, buckets, serve, root)
    return runs


# the sample phase: the real sampled config, its two seeds, how many
# requests a run holds against a teacher-forced top-k ∩ nucleus, and the
# beam plan whose K1 launches are counted
SAMPLE_TOP = dict(temperature=0.8, top_k=50, top_p=0.95)
SAMPLE_SEEDS = (1234, 4321)
SAMPLE_CHECKED = 4
#: phase 7's first requests that the sampled slot runs serve
SAMPLE_SLOT_REQUESTS = 6
SAMPLE_SLACK = 1e-4  # on the logit, teacher-forced against the served step
TOP_P_EDGE = 1e-6    # a top-p keep-set difference is excused this close to p
SAMPLE_FILTERS = {
    "temperature": dict(do_sample=True, temperature=0.7),
    "top_k": dict(do_sample=True, top_k=50),
    "top_p": dict(do_sample=True, top_p=0.9),
    "repetition_penalty": dict(do_sample=True, repetition_penalty=1.2),
    "combined": dict(do_sample=True, temperature=0.7, top_k=50, top_p=0.9, repetition_penalty=1.2),
}
BEAM_WIDTH, BEAM_STEPS = 4, 16
PIPE_PROMPTS = ("The Perceiver AR model reads a long context through a few latents",
                "Sampling draws each token from the filtered distribution",
                "Beam search keeps the best hypotheses at every step of the way")


def _windows(torch, model, contexts):
    """Right-aligned windows and pads for token contexts (each cut to its
    last ``max_seq_len`` tokens)."""
    n = model.max_seq_len
    window = torch.zeros((len(contexts), n), dtype=torch.long, device=model.device)
    pad = torch.zeros((len(contexts),), dtype=torch.long, device=model.device)
    for r, ctx in enumerate(contexts):
        ctx = list(ctx)[-n:]
        window[r, n - len(ctx):] = torch.tensor(ctx, device=model.device)
        pad[r] = n - len(ctx)
    return window, pad


def _teacher_logits(torch, gen_mod, model, prompt, tokens, num_latents: int):
    """``(T, V)`` next-token logits before each of ``tokens``: one
    full-recompute forward of the request's own prefix per step, at the
    step's latent count, batched over the steps."""
    contexts = [list(prompt) + list(tokens[:t]) for t in range(len(tokens))]
    window, pad = _windows(torch, model, contexts)
    m = torch.tensor([min(num_latents + t, model.max_latents) for t in range(len(tokens))],
                     device=model.device)
    with torch.no_grad():
        return gen_mod._decode_forward(model, window, pad, m).float()


def _nucleus_shortfall(torch, gen_mod, samplers, model, cfg, prompt, row) -> tuple:
    """Per token of a sampled request: how far its logit lies below the
    smallest logit ``cfg`` keeps at that step (top-k ∩ nucleus of the
    teacher-forced logits; <= 0 inside), and how many tokens that keeps."""
    tokens = [int(t) for t in row]
    logits = _teacher_logits(torch, gen_mod, model, prompt, tokens, cfg.num_latents)
    kept = samplers.filter_logits(logits, cfg.sampling) > samplers.NEG_INF
    threshold = torch.where(kept, logits, torch.full_like(logits, float("inf"))).min(-1).values
    chosen = logits[torch.arange(len(tokens), device=logits.device),
                    torch.tensor(tokens, device=logits.device)]
    return (threshold - chosen).cpu().tolist(), kept.sum(-1).cpu().tolist()


def _top_p_edge_rows(torch, logits, p: float):
    """Per row: the logit values whose top-p keep decision sits within
    ``TOP_P_EDGE`` of ``p`` (``|cum - probs - p|``, in float64)."""
    s = torch.sort(logits.double(), dim=-1, descending=True).values
    probs = torch.softmax(s, dim=-1)
    near = (torch.cumsum(probs, -1) - probs - p).abs() < TOP_P_EDGE
    return [set(s[r][near[r]].tolist()) for r in range(len(s))]


def sample_filters(torch, gen_mod, samplers, serve) -> dict:
    """(a) The sampler on the card against its plain CPU path: ``(4, V)``
    logits of phase 7's model over its first 4 prompts, a seeded numpy
    Gumbel table fed through ``samplers.gumbel_noise``; per filter config the
    filtered logits equal (a top-p keep-set difference excused within
    ``TOP_P_EDGE`` of the boundary) and the tokens identical. Then the
    sampler's device ms a step (the combined config, its own draw)."""
    import dataclasses

    import numpy as np

    model = serve["model"]
    gcfg = serve["gcfg"]
    window, pad = _windows(torch, model, serve["prompts"][:4])
    with torch.no_grad():
        logits = gen_mod._decode_forward(model, window, pad, gcfg.num_latents).float()
    mask = torch.arange(model.max_seq_len, device=model.device)[None, :] < pad[:, None]
    table = torch.from_numpy(np.random.default_rng(5).gumbel(size=tuple(logits.shape)).astype(np.float32))
    draw = samplers.gumbel_noise
    samplers.gumbel_noise = lambda shape, generator, device: table.to(device)
    lines, failures = {}, []
    try:
        for name, kw in SAMPLE_FILTERS.items():
            cfg = samplers.SamplingConfig(**kw)
            out = {}
            for dev in ("card", "cpu"):
                x, ctx, msk = (t if dev == "card" else t.cpu() for t in (logits, window, mask))
                gen = torch.Generator(device=x.device).manual_seed(0)  # the table stands in for it
                out[dev] = (samplers.filter_logits(x, cfg, ctx, msk).cpu(),
                            samplers.sample_logits(x, cfg, ctx, msk, generator=gen).cpu())
            (f_card, tok_card), (f_cpu, tok_cpu) = out["card"], out["cpu"]
            differ = f_card != f_cpu
            excused = 0
            if cfg.top_p is not None and differ.any():
                # the values top-p sees: every filter before it, on the CPU
                seen = samplers.filter_logits(logits.cpu(), dataclasses.replace(cfg, top_p=None),
                                              window.cpu(), mask.cpu())
                edge = _top_p_edge_rows(torch, seen, cfg.top_p)
                for r, v in differ.nonzero().tolist():
                    if float(seen[r, v]) in edge[r]:
                        differ[r, v] = False
                        excused += 1
            kept = (f_cpu > samplers.NEG_INF).sum(-1).tolist()
            lines[name] = dict(kept_per_row=kept, values_differing=int(differ.sum()),
                               top_p_edge_excused=excused,
                               tokens_card=tok_card.tolist(), tokens_cpu=tok_cpu.tolist())
            if differ.any() or not torch.equal(tok_card, tok_cpu):
                failures.append(f"{name}: {int(differ.sum())} filtered values differ, tokens "
                                f"{tok_card.tolist()} on the card against {tok_cpu.tolist()}")
    finally:
        samplers.gumbel_noise = draw
    combined = samplers.SamplingConfig(**SAMPLE_FILTERS["combined"])
    gen = torch.Generator(device=model.device).manual_seed(0)
    step_ms = None
    if model.device.type == "cuda":
        step_ms = device_ms(lambda: samplers.sample_logits(logits, combined, window, mask,
                                                           generator=gen), 50)
    emit("sample", part="filters", shape=list(logits.shape), configs=lines,
         sampler_device_ms_per_step=step_ms)
    if failures:
        raise AssertionError("sample filters: " + "; ".join(failures))
    return {"sampler_device_ms_per_step": step_ms}


def _with_sampling(samplers, cfg, **kw):
    import dataclasses

    return dataclasses.replace(cfg, sampling=samplers.SamplingConfig(**kw))


def _bucket_run(torch, engine_mod, model, table, work, generator=None):
    """Serve phase 5's workload groups through a fresh bucket engine;
    ``(rows per group, wall_s, stats)``."""
    engine = engine_mod.ServingEngine(model, table=table, device=model.device, generator=generator)
    if model.device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows = [engine.serve(prompts, c) for c, prompts in work]
    if model.device.type == "cuda":
        torch.cuda.synchronize()
    return rows, time.perf_counter() - t0, engine.stats()


def _slot_run(torch, slots_mod, buckets, model, gcfg, configs, prompts, layout, generator=None):
    """Phase 7's requests through a fresh slot engine: ``(rows, wall_s,
    stats, engine)``."""
    table = buckets.BucketTable(prompt_lens=SLOT_BUCKETS, batch_sizes=(1,))
    engine = slots_mod.SlotServingEngine(model, gcfg, table, slots=4, kv_layout=layout,
                                         device=model.device, generator=generator)
    if model.device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = [engine.submit(p, c) for p, c in zip(prompts, configs)]
    engine.run_until_idle()
    if model.device.type == "cuda":
        torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    if any(r.status != "ok" for r in reqs):
        raise AssertionError(f"slot run {layout}: statuses {[r.status for r in reqs]}")
    return [r.result for r in reqs], wall_s, engine.stats(), engine


def sample_top1(torch, gen_mod, samplers, engine_mod, slots_mod, buckets, serve, bucket_work) -> dict:
    """(b) ``do_sample=True, top_k=1`` equals greedy: the bucket engine over
    phase 5's workload against a greedy run of the same engine, the slot
    engine dense and paged over phase 7's against its ``generate()``
    references (the near-tie excuse of phase 7 in both)."""
    model = serve["model"]
    table, work = bucket_work
    greedy, greedy_s, _ = _bucket_run(torch, engine_mod, model, table, work)
    top1_work = [(_with_sampling(samplers, c, do_sample=True, top_k=1), p) for c, p in work]
    top1, top1_s, stats = _bucket_run(torch, engine_mod, model, table, top1_work)
    failures = []
    prompts = [p for _, ps in work for p in ps]
    configs = [c for c, ps in work for _ in ps]
    tokens = sum(c.max_new_tokens for c in configs)
    div = _divergences(torch, gen_mod, model, [r for g in top1 for r in g],
                       [r for g in greedy for r in g], prompts, configs, failures)
    emit("sample", part="top1", engine="bucket", requests=stats["completed"], tokens=tokens,
         tokens_per_s=tokens / top1_s, greedy_tokens_per_s=tokens / greedy_s,
         divergences_vs_greedy=div)
    out = {"bucket_greedy": {"rows": greedy, "tokens_per_s": tokens / greedy_s}}
    gcfg1 = _with_sampling(samplers, serve["gcfg"], do_sample=True, top_k=1)
    configs1 = [_with_sampling(samplers, c, do_sample=True, top_k=1) for c in serve["configs"]]
    for layout in ("dense", "paged"):
        rows, wall_s, stats, _ = _slot_run(torch, slots_mod, buckets, model, gcfg1, configs1,
                                           serve["prompts"], layout)
        tokens = sum(c.max_new_tokens for c in configs1)
        div = _divergences(torch, gen_mod, model, rows, serve["refs"], serve["prompts"],
                           serve["configs"], failures)
        emit("sample", part="top1", engine="slots", layout=layout, requests=stats["completed"],
             tokens=tokens, tokens_per_s=tokens / wall_s, divergences_vs_generate=div)
    if failures:
        raise AssertionError("sample top_k=1: " + "; ".join(failures))
    return out


def sample_runs(torch, flash, ragged, gen_mod, samplers, engine_mod, slots_mod, buckets, serve,
                unpressured, bucket_work, bucket_greedy) -> dict:
    """(c) The real sampled config (``SAMPLE_TOP``) through the bucket engine
    over phase 5's workload, then the slot engine over phase 7's first
    ``SAMPLE_SLOT_REQUESTS`` under dense and paged: each run three times (seed A, seed A again, seed B).
    Gates: every request completes; seed A twice gives identical tokens and
    seeds A and B differ in at least one; the first ``SAMPLE_CHECKED``
    requests' tokens lie in their step's top-k ∩ nucleus of a
    teacher-forced forward (slack ``SAMPLE_SLACK``); K1's fp32 tiles on
    ``tf32x3``, K4 on ``split``/``tc``, never ``simt``; the pool leak-free.
    Returns each run's launches (the first seed's run)."""
    model = serve["model"]
    on_card = model.device.type == "cuda"
    table, work = bucket_work
    runs = [("bucket", None)] + [(f"slots_{layout}", layout) for layout in ("dense", "paged")]
    out = {}
    swork = [(_with_sampling(samplers, c, do_sample=True, **SAMPLE_TOP), p) for c, p in work]
    gcfg = _with_sampling(samplers, serve["gcfg"], do_sample=True, **SAMPLE_TOP)
    for name, layout in runs:
        if layout is None:
            prompts = [p for _, ps in swork for p in ps]
            configs = [c for c, ps in swork for _ in ps]
        else:
            prompts = serve["prompts"][:SAMPLE_SLOT_REQUESTS]
            configs = [_with_sampling(samplers, c, do_sample=True, **SAMPLE_TOP)
                       for c in serve["configs"][:SAMPLE_SLOT_REQUESTS]]
        results = []
        for seed in (SAMPLE_SEEDS[0], SAMPLE_SEEDS[0], SAMPLE_SEEDS[1]):
            gen = torch.Generator(device=model.device).manual_seed(seed)
            reset_counts(flash)  # count this run's launches only
            reset_k4_counts(ragged)
            if layout is None:
                groups, wall_s, stats = _bucket_run(torch, engine_mod, model, table, swork, gen)
                rows, pool = [r for g in groups for r in g], None
            else:
                rows, wall_s, stats, engine = _slot_run(torch, slots_mod, buckets, model, gcfg,
                                                        configs, prompts, layout, gen)
                pool = engine._pool
                del engine
            results.append(dict(rows=rows, wall_s=wall_s, stats=stats,
                                k1=flash.flash_attention.launches,
                                k1_routes=dict(flash.flash_attention.route_launches),
                                k4=ragged.ragged_paged_attention.launches,
                                k4_routes=dict(ragged.ragged_paged_attention.route_launches),
                                pool=None if pool is None else (pool.in_use, pool.leaked())))
        first, again, other = results
        tokens = sum(c.max_new_tokens for c in configs)
        same = all((a == b).all() for a, b in zip(first["rows"], again["rows"]))
        differing = sum(int((a != b).sum()) for a, b in zip(first["rows"], other["rows"]))
        # two requests of each bucket group, or phase 7's first four
        picks = [0, 1, 4, 5] if layout is None else list(range(SAMPLE_CHECKED))
        outside, worst, kept = [], float("-inf"), []
        for i in picks:
            short, counts = _nucleus_shortfall(torch, gen_mod, samplers, model, configs[i],
                                               prompts[i], first["rows"][i])
            worst, kept = max(worst, max(short)), kept + counts
            outside += [{"request": i, "token": t, "short": s}
                        for t, s in enumerate(short) if s > SAMPLE_SLACK]
        phase7 = unpressured[layout]["tokens_per_s"] if layout else bucket_greedy["tokens_per_s"]
        line = dict(part="sampled", run=name, layout=layout, seeds=list(SAMPLE_SEEDS),
                    config=SAMPLE_TOP, requests=first["stats"]["completed"], tokens=tokens,
                    tokens_per_s=[tokens / r["wall_s"] for r in results],
                    greedy_tokens_per_s=phase7,
                    greedy_from="phase 7" if layout else "this phase's greedy bucket run",
                    same_seed_identical=same, other_seed_tokens_differing=differing,
                    nucleus_checked_requests=picks, nucleus_outside=outside,
                    nucleus_largest_shortfall=worst, nucleus_kept_mean=_mean(kept),
                    nucleus_kept_range=[min(kept), max(kept)],
                    k1_launches=first["k1"], k1_route_launches=first["k1_routes"],
                    k4_launches=first["k4"], k4_route_launches=first["k4_routes"])
        if layout is not None:
            st = first["stats"]
            line.update(decode_steps=st["decode_steps"], boundary_steps=st["boundary_steps"],
                        decode_step_ms_p50=st["decode_step_ms"]["p50"],
                        ttft_ms_p50=st["ttft_ms"]["p50"])
        failures = []
        if any(r["stats"]["completed"] != len(prompts) for r in results):
            failures.append(f"completed {[r['stats']['completed'] for r in results]} of {len(prompts)}")
        if not same or differing == 0:
            failures.append(f"seed A twice identical: {same}; seeds A and B differ in {differing} tokens")
        if outside:
            failures.append(f"{len(outside)} tokens outside top-k ∩ nucleus: {outside[:4]}")
        for r in results:
            if r["pool"] is not None and r["pool"] != (0, 0):
                failures.append(f"pool in_use/leaked {r['pool']}")
        if on_card:
            k1r, k4r = first["k1_routes"], first["k4_routes"]
            if k1r["simt"] or not k1r["tf32x3"] or k1r["wgmma"]:
                failures.append(f"K1 routes {k1r}: fp32 tiles on tf32x3, never simt")
            paged = layout == "paged"
            if k4r["simt"] or (paged and not (k4r["split"] and k4r["tc"])) or (not paged and first["k4"]):
                failures.append(f"K4 routes {k4r} under {layout}: split/tc only, none unpaged")
        emit("sample", **line)
        if failures:
            raise AssertionError(f"sample {name}: " + "; ".join(failures))
        out[name] = {"k1": first["k1"], "k1_routes": first["k1_routes"], "k4": first["k4"],
                     "k4_routes": first["k4_routes"]}
        if on_card:
            torch.cuda.empty_cache()
    return out


def sample_beam(torch, clm, flash, gen_mod, beam_mod, serve, bucket_work) -> dict:
    """(d) Beam search. ``beam_search(num_beams=1)`` over 2 of phase 5's
    prompts equals per-request greedy ``generate()`` (near-tie excuse);
    ``generate(num_beams=BEAM_WIDTH, max_new_tokens=BEAM_STEPS,
    min_new_tokens=BEAM_STEPS)`` on 2 prompts runs exactly 1 + layers K1
    calls a step (1 cross + the stack's attends), all ``tf32x3`` on the card, timed a
    step; a bf16 twin's agreement is printed; a small model's beam tokens on
    the card equal the same weights' on the CPU. Returns K1's launches."""
    import dataclasses

    import numpy as np

    model = serve["model"]
    on_card = model.device.type == "cuda"
    _, work = bucket_work
    cfg, prompts = work[0][0], list(work[0][1][:2])
    width = max(p.size for p in prompts)
    ids = np.stack([np.pad(p, (width - p.size, 0)) for p in prompts]).astype(np.int64)
    pads = np.array([width - p.size for p in prompts])
    failures = []
    one = beam_mod.beam_search(model, ids, cfg, num_beams=1, prompt_pad_count=pads,
                               device=model.device).cpu().numpy()
    refs = [gen_mod.generate(model, p[None], cfg, device=model.device)[0].cpu().numpy()
            for p in prompts]
    one_div = _divergences(torch, gen_mod, model, list(one), refs, prompts, [cfg, cfg], failures)

    bcfg = dataclasses.replace(cfg, max_new_tokens=BEAM_STEPS, min_new_tokens=BEAM_STEPS,
                               eos_token_id=2, num_beams=BEAM_WIDTH)
    layers = model.config.num_self_attention_layers
    reset_counts(flash)  # count the beam run's launches only
    if on_card:
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    rows = gen_mod.generate(model, ids, bcfg, prompt_pad_count=pads, device=model.device).cpu().numpy()
    wall_s = time.perf_counter() - t0
    step_ms = None
    if on_card:
        end.record()
        end.synchronize()
        step_ms = start.elapsed_time(end) / BEAM_STEPS
    launches, routes = flash.flash_attention.launches, dict(flash.flash_attention.route_launches)
    if on_card and (launches != BEAM_STEPS * (1 + layers) or routes["tf32x3"] != launches):
        failures.append(f"K1 {launches} launches {routes} over {BEAM_STEPS} beam steps, not "
                        f"{BEAM_STEPS * (1 + layers)} all on tf32x3")
    if rows.shape != (2, BEAM_STEPS) or (rows == 2).any():
        failures.append(f"beam rows {rows.shape}, EOS inside min_new_tokens: {(rows == 2).any()}")

    bf16 = clm.CausalLanguageModel(model.config, dtype=torch.bfloat16, seed=0,
                                   device=model.device).eval()
    twin = gen_mod.generate(bf16, ids, bcfg, prompt_pad_count=pads, device=model.device).cpu().numpy()
    del bf16

    small = clm.CausalLanguageModelConfig(
        vocab_size=256, max_seq_len=64, max_latents=32, num_channels=128, num_heads=2,
        num_self_attention_layers=2, init_scale=0.1,
    )
    cpu = clm.CausalLanguageModel(small, device="cpu", seed=3).eval()
    card = clm.CausalLanguageModel(small, seed=0, device=model.device).eval()
    card.load_state_dict(cpu.state_dict())
    sids = torch.randint(1, 256, (3, 20), generator=torch.Generator().manual_seed(4))
    spads = torch.tensor([0, 5, 2])
    scfg = gen_mod.GenerationConfig(max_new_tokens=24, num_latents=8, num_beams=3,
                                    eos_token_id=7, length_penalty=0.9)
    small_cpu = gen_mod.generate(cpu, sids, scfg, prompt_pad_count=spads, device="cpu").numpy()
    small_card = gen_mod.generate(card, sids, scfg, prompt_pad_count=spads,
                                  device=model.device).cpu().numpy()
    if not (small_cpu == small_card).all():
        failures.append(f"small model beam on the card {small_card.tolist()} against the CPU "
                        f"{small_cpu.tolist()}")
    emit("sample", part="beam", num_beams_1_divergences_vs_generate=one_div,
         num_beams=BEAM_WIDTH, steps=BEAM_STEPS, lanes=2 * BEAM_WIDTH, wall_s=wall_s,
         step_ms=step_ms, k1_launches=launches, k1_route_launches=routes,
         k1_launches_per_step=launches / BEAM_STEPS, k1_launches_per_step_expected=1 + layers,
         tokens=rows.tolist(), bf16_token_agreement=float((twin == rows).mean()),
         small_model_tokens_equal=bool((small_cpu == small_card).all()))
    if failures:
        raise AssertionError("sample beam: " + "; ".join(failures))
    return {"k1": launches, "k1_routes": routes}


def sample_pipeline(torch, clm, pipelines_mod, tokenizers_mod, serve) -> None:
    """(e) ``TextGenerationPipeline`` over clm-base's widths with the byte
    tokenizer's 262-token vocabulary (random weights from a seed):
    ``bucketing=True`` gives the text ``bucketing=False`` gives, and a beam
    call returns text."""
    import dataclasses

    base = serve["model"]
    model = clm.CausalLanguageModel(dataclasses.replace(base.config, vocab_size=262), seed=5,
                                    device=base.device).eval()
    tok = tokenizers_mod.ByteTokenizer()
    kw = dict(max_new_tokens=24, num_latents=32)
    direct = pipelines_mod.pipeline("text-generation", model, tok, device=base.device)
    bucketed = pipelines_mod.pipeline("text-generation", model, tok, bucketing=True, device=base.device)
    t0 = time.perf_counter()
    want = direct(list(PIPE_PROMPTS), **kw)
    direct_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = bucketed(list(PIPE_PROMPTS), **kw)
    bucketed_s = time.perf_counter() - t0
    beam = direct(list(PIPE_PROMPTS[:2]), num_beams=3, max_new_tokens=8, num_latents=32,
                  return_full_text=False)
    emit("sample", part="pipeline", vocab=262, prompts=len(PIPE_PROMPTS), direct_s=direct_s,
         bucketed_s=bucketed_s, bucketed_equal=got == want,
         continuations=[repr(t[len(p):]) for t, p in zip(want, PIPE_PROMPTS)],
         beam_texts=[repr(t) for t in beam], serving_stats_batches=bucketed.serving_stats()["batches"])
    if got != want or not all(isinstance(t, str) for t in beam) or len(beam) != 2:
        raise AssertionError(f"sample pipeline: bucketed {got!r} against direct {want!r}; beam {beam!r}")
    del model


def sample_phase(torch, clm, flash, ragged, gen_mod, samplers, beam_mod, pipelines_mod,
                 tokenizers_mod, engine_mod, slots_mod, buckets, serve, unpressured) -> dict:
    """Sampled decoding and beam search (module docstring, phase 11), over
    phase 7's model, requests and references and phase 5's workload.
    Returns the launches of the sampled runs and of the beam run."""
    bucket_work = serve_workload(torch, gen_mod, buckets, serve["model"].config.vocab_size)
    filters = sample_filters(torch, gen_mod, samplers, serve)
    top1 = sample_top1(torch, gen_mod, samplers, engine_mod, slots_mod, buckets, serve, bucket_work)
    runs = sample_runs(torch, flash, ragged, gen_mod, samplers, engine_mod, slots_mod, buckets,
                       serve, unpressured, bucket_work, top1["bucket_greedy"])
    beam = sample_beam(torch, clm, flash, gen_mod, beam_mod, serve, bucket_work)
    sample_pipeline(torch, clm, pipelines_mod, tokenizers_mod, serve)
    return {"runs": runs, "beam": beam, **filters}


def _mean(values):
    return sum(values) / len(values) if values else None


def token_batches(vocab_size: int, seq_len: int, rows: int, n: int, seed: int, pads=None,
                  distinct: int = 1024):
    """``n`` batches of ``rows`` token rows (``seq_len`` inputs and their
    next-token labels), each token drawn uniformly from one fixed random set
    of ``distinct`` ids of the vocabulary; ``pads`` left-pads row ``r`` by
    ``pads[r]`` positions. With a small set the loss has room to fall within
    a few steps at a small learning rate (a Zipf law over the whole
    vocabulary made the first Adam steps overshoot; ``PERF.md``)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    ids = rng.permutation(vocab_size)[:distinct]
    out = []
    for _ in range(n):
        tokens = ids[rng.integers(0, distinct, size=(rows, seq_len + 1))]
        batch = {"input_ids": tokens[:, :-1], "labels": tokens[:, 1:]}
        if pads is not None:
            batch["pad_mask"] = np.arange(seq_len)[None, :] < np.asarray(pads)[:, None]
        out.append(batch)
    return out


def reset_counts(flash) -> None:
    flash.flash_attention.launches = 0
    flash.flash_attention.route_launches = dict.fromkeys(flash.ROUTES, 0)
    flash.flash_attention.kernel_launches = 0
    for wrapper in (flash.flash_attention_bwd_dq, flash.flash_attention_bwd_dkv):
        wrapper.launches = 0
        wrapper.route_launches = dict.fromkeys(flash.BWD_ROUTES, 0)


def reset_k4_counts(ragged) -> None:
    ragged.ragged_paged_attention.launches = 0
    ragged.ragged_paged_attention.route_launches = dict.fromkeys(ragged.ROUTES, 0)
    ragged.ragged_paged_attention.kernel_launches = 0


def read_counts(flash) -> dict:
    return {"k1": flash.flash_attention.launches, "k2": flash.flash_attention_bwd_dq.launches,
            "k3": flash.flash_attention_bwd_dkv.launches}


def read_bwd_routes(flash) -> dict:
    """K2's and K3's launches per route."""
    return {"k2": dict(flash.flash_attention_bwd_dq.route_launches),
            "k3": dict(flash.flash_attention_bwd_dkv.route_launches)}


def _grad_errors(grads, ref) -> dict:
    """Per parameter: ``max|g - ref|`` and ``max|ref|``."""
    return {n: ((g - ref[n]).abs().max().item(), ref[n].abs().max().item())
            for n, g in grads.items() if g is not None and ref[n] is not None}


def bf16_ulp(x: float) -> float:
    """One bf16 unit in the last place at magnitude ``x`` (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(x)) - 7) if x > 0 else 0.0


def train_grad_gate(torch, clm, flash, training, parallel):
    """(a) one loss + backward of the full-width CLM with the kernels against
    ``attention_impl="xla"``, same batch and prefix-dropout seed. Left pads
    stay inside the prefix: with pads reaching the latents the two differ on
    live rows by design (module docstring of ``models/core``).

    fp32: every gradient within ``1e-3 * max|g_xla|``, the loss within 1e-5,
    every K2/K3 launch on the ``tf32x3`` route. bf16 compute (the same fp32
    parameters): each parameter's kernel-path gradient, against the fp32
    ``xla`` gradient, within 1.5x the bf16 ``xla`` path's own error plus one
    bf16 ulp of the largest entry; every K2/K3 launch on the ``wgmma``
    route."""
    cfg = clm_base_config(clm.CausalLanguageModelConfig)
    model = clm.CausalLanguageModel(cfg, seed=0)
    loss_fn = training.clm_loss_fn(model, cfg.max_latents)
    batch = parallel.train_step.to_device(
        token_batches(cfg.vocab_size, cfg.max_seq_len, 4, 1, seed=21, pads=[0, 37, 200, 512])[0],
        torch.device("cuda"))

    def loss_and_grads(m, impl):
        set_attention_impl(m, impl)
        m.zero_grad(set_to_none=True)
        loss, _ = loss_fn(m, batch, torch.Generator(device="cuda").manual_seed(7))
        loss.backward()
        return loss.item(), {n: None if p.grad is None else p.grad.detach().clone()
                             for n, p in m.named_parameters()}

    reset_counts(flash)
    loss, grads = loss_and_grads(model, "auto")
    torch.cuda.synchronize()
    launches, routes = read_counts(flash), read_bwd_routes(flash)
    k1_routes = dict(flash.flash_attention.route_launches)
    ref_loss, ref = loss_and_grads(model, "xla")
    set_attention_impl(model, "auto")
    missing = [n for n in grads if grads[n] is None or ref[n] is None]
    nonfinite = [n for n, g in grads.items() if g is not None and not bool(torch.isfinite(g).all())]
    rel = {n: (diff / scale if scale > 0 else (0.0 if diff == 0 else math.inf))
           for n, (diff, scale) in _grad_errors(grads, ref).items()}
    qkv = {n: r for n, r in rel.items() if any(f".{w}_proj." in n for w in "qkv")}
    worst = sorted(rel.items(), key=lambda kv: -kv[1])[:3]
    loss_rel = abs(loss - ref_loss) / abs(ref_loss)
    emit("train_grad", params=len(grads), loss=loss, xla_loss=ref_loss, loss_rel_err=loss_rel,
         max_rel_grad_err=max(rel.values()), worst=worst, qkv_proj_params=len(qkv),
         qkv_max_rel_grad_err=max(qkv.values()), none_grads=missing, nonfinite_grads=nonfinite,
         launches=launches, k1_route_launches=k1_routes, bwd_route_launches=routes, tol=1e-3,
         loss_tol=1e-5, compute_dtype="float32")
    expected = {"k1": 17, "k2": 17, "k3": 17}  # 1 cross + 16 stack attends

    def on_route(route):
        return {key: {r: (17 if r == route else 0) for r in flash.BWD_ROUTES} for key in ("k2", "k3")}

    def k1_on(route):
        return {r: (17 if r == route else 0) for r in flash.ROUTES}

    if (missing or nonfinite or loss_rel > 1e-5 or max(rel.values()) > 1e-3 or not qkv
            or launches != expected or routes != on_route(K23_ROUTE["float32"])
            or k1_routes != k1_on("tf32x3")):
        raise AssertionError(f"train grad gate: loss rel {loss_rel}, worst {worst}, None {missing}, "
                             f"non-finite {nonfinite}, launches {launches}, routes {routes}, "
                             f"K1 routes {k1_routes}")
    del grads

    # bf16 compute over the same parameters, batch and seed
    half = clm.CausalLanguageModel(cfg, dtype=torch.bfloat16, seed=0)
    half.load_state_dict(model.state_dict())
    del model
    reset_counts(flash)
    loss16, grads16 = loss_and_grads(half, "auto")
    torch.cuda.synchronize()
    launches16, routes16 = read_counts(flash), read_bwd_routes(flash)
    k1_routes16 = dict(flash.flash_attention.route_launches)
    xla_loss16, xla16 = loss_and_grads(half, "xla")
    kernel_err, xla_err = _grad_errors(grads16, ref), _grad_errors(xla16, ref)
    missing16 = [n for n in grads16 if grads16[n] is None or xla16[n] is None]
    nonfinite16 = [n for n, g in grads16.items() if g is not None and not bool(torch.isfinite(g).all())]
    over = {}
    ratios = {}
    for n, (diff, scale) in kernel_err.items():
        limit = 1.5 * xla_err[n][0] + bf16_ulp(scale)
        ratios[n] = diff / limit if limit > 0 else (0.0 if diff == 0 else math.inf)
        if diff > limit:
            over[n] = (diff, xla_err[n][0], scale)
    worst16 = sorted(ratios.items(), key=lambda kv: -kv[1])[:3]
    emit("train_grad", params=len(grads16), loss=loss16, xla_loss=xla_loss16, fp32_xla_loss=ref_loss,
         max_rel_grad_err_vs_fp32_xla=max(d / s for d, s in kernel_err.values() if s > 0),
         xla_max_rel_grad_err_vs_fp32_xla=max(d / s for d, s in xla_err.values() if s > 0),
         worst_err_over_limit=worst16, params_over_limit=over, none_grads=missing16,
         nonfinite_grads=nonfinite16, launches=launches16, k1_route_launches=k1_routes16,
         bwd_route_launches=routes16,
         limit="1.5 x the bf16 xla path's max abs error against the fp32 xla gradient "
               "+ 1 bf16 ulp of its largest entry, per parameter", compute_dtype="bfloat16")
    if (over or missing16 or nonfinite16 or not math.isfinite(loss16) or launches16 != expected
            or routes16 != on_route(K23_ROUTE["bfloat16"]) or k1_routes16 != k1_on("wgmma")):
        raise AssertionError(f"bf16 train grad gate: over the limit {over}, None {missing16}, "
                             f"non-finite {nonfinite16}, launches {launches16}, routes {routes16}, "
                             f"K1 routes {k1_routes16}")
    del half, grads16, xla16, ref
    torch.cuda.empty_cache()


def train_fit(torch, flash, training, parallel, model_cls, cfg, dtype, root: Path, data, batches, val,
              lr: float = 1e-4, warmup_steps: int = 2, phase: str = "train_fit", make_loss=None,
              attends: Optional[int] = None, tokens_per_step: Optional[int] = None, wide: int = 0):
    """(b)/(c) ``Trainer.fit`` at full width: a fresh ``model_cls(cfg)``, 8
    optimizer steps over ``data`` (8 rows, 2 microbatches), AdamW to ``lr``
    under a cosine schedule with ``warmup_steps``, clipping, prefix dropout
    0.5, one validation pass over ``val`` at the end; then the step time
    over ``batches`` (two of ``data``'s). K1, K2 and K3 launch once an
    attend: 2 microbatches x (1 + the stack's layers) a step.

    The Perceiver AR families' defaults, for another family: ``make_loss``
    ``(model, cfg) -> loss_fn`` (default ``clm_loss_fn`` over the latents),
    ``attends`` K1/K2/K3 launches a step, ``wide`` of them at head dims
    outside ``HEAD_DIMS`` (K1 on ``K1_WIDE_ROUTE``, its validation forwards
    in the same share; K2/K3 on ``K23_WIDE_ROUTE``) and ``tokens_per_step`` loss
    tokens a step (default 8 rows x ``max_latents``)."""
    import numpy as np

    tname = str(dtype).split(".")[-1]
    model = model_cls(cfg, dtype=dtype, seed=0)
    schedule = training.cosine_with_warmup(lr, warmup_steps=warmup_steps, training_steps=TRAIN_STEPS)
    tcfg = training.TrainerConfig(
        max_steps=TRAIN_STEPS, val_check_interval=TRAIN_STEPS, log_every_n_steps=1,
        grad_clip_norm=1.0, grad_accum_steps=2, limit_val_batches=1, enable_tensorboard=False,
        default_root_dir=str(root),
    )
    if make_loss is None:
        make_loss = lambda model, cfg: training.clm_loss_fn(model, cfg.max_latents)  # noqa: E731
    trainer = training.Trainer(tcfg, make_loss(model, cfg),
                               training.make_optimizer(schedule, optimizer="adamw"),
                               model_config=cfg, lr_schedule=schedule)
    validate, val_counts = trainer.validate, {"k1": 0, "k2": 0, "k3": 0}

    def counted_validate(data):  # validation's launches, counted apart
        before = read_counts(flash)
        out = validate(data)
        for key, n in read_counts(flash).items():
            val_counts[key] += n - before[key]
        return out

    trainer.validate = counted_validate
    torch.cuda.reset_peak_memory_stats()
    reset_counts(flash)  # the main path's launches: this fit only
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = trainer.fit(model, data, val_data=lambda: iter(val))
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    counts = read_counts(flash)
    routes = dict(flash.flash_attention.route_launches)  # validation's included
    bwd_routes = read_bwd_routes(flash)  # validation launches no K2/K3 (gated below)
    k1_kernels = flash.flash_attention.kernel_launches
    train_counts = {k: counts[k] - val_counts[k] for k in counts}
    peak_bytes = torch.cuda.max_memory_allocated()
    rows = [json.loads(line) for line in open(root / "metrics.jsonl")]
    losses = [r["train/loss"] for r in rows if "train/loss" in r]
    val_loss = [r["val/loss"] for r in rows if "val/loss" in r]

    ckpt_equal = None
    if dtype == torch.float32:
        manager = training.BestCheckpointManager(str(root / "checkpoints"))
        state_dict, config = manager.restore_best()
        again = model_cls(cfg, seed=1)
        again.load_state_dict(state_dict, strict=True)
        ckpt_equal = manager.best_step == TRAIN_STEPS and config["vocab_size"] == cfg.vocab_size and all(
            torch.equal(a, b) for a, b in zip(again.state_dict().values(), model.state_dict().values()))
        del again, state_dict

    # step time: a few more steps of the same train step, each synchronised
    step = parallel.make_train_step(trainer.loss_fn, grad_clip_norm=1.0, grad_accum_steps=2)
    step_ms = []
    for i in range(3):
        gen = torch.Generator(device="cuda").manual_seed(100 + i)
        t1 = time.perf_counter()
        state, metrics = step(state, batches[i % 2], gen)
        metrics["loss"].item()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
    p50 = float(np.median(step_ms))
    tokens = tokens_per_step or 8 * cfg.max_latents  # loss tokens per optimizer step
    per_step = {k: v / TRAIN_STEPS for k, v in train_counts.items()}
    line = dict(compute_dtype=tname, steps=TRAIN_STEPS, rows=8, grad_accum_steps=2, losses=losses,
                val_loss=val_loss, launches=train_counts, launches_per_step=per_step,
                validation_launches=val_counts, k1_route_launches=routes, bwd_route_launches=bwd_routes,
                k1_kernel_launches=k1_kernels, fit_s=fit_s,
                step_ms=step_ms, step_ms_p50=p50,
                loss_tokens_per_s=tokens / (p50 / 1e3), max_memory_allocated=peak_bytes,
                checkpoint_reloads_equal=ckpt_equal)
    emit(phase, **line)
    failures = []
    if not (len(losses) == TRAIN_STEPS and all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]):
        failures.append(f"losses {losses}")
    attends = attends or 2 * (1 + cfg.num_self_attention_layers)
    if per_step != {"k1": attends, "k2": attends, "k3": attends} or val_counts["k2"] or val_counts["k3"]:
        failures.append(f"launches per step {per_step}, validation {val_counts}")
    expected_route = "wgmma" if dtype == torch.bfloat16 else "tf32x3"  # i = the latents
    if (routes[expected_route] + routes[K1_WIDE_ROUTE] != counts["k1"]
            or routes[K1_WIDE_ROUTE] * attends != counts["k1"] * wide):
        failures.append(f"K1 routes {routes}: every launch should take {expected_route}, "
                        f"{wide} of {attends} {K1_WIDE_ROUTE}")
    expected_bwd = K23_ROUTE[tname]
    for key, by_route in bwd_routes.items():
        if (by_route[expected_bwd] != (attends - wide) * TRAIN_STEPS
                or by_route[K23_WIDE_ROUTE] != wide * TRAIN_STEPS or sum(by_route.values()) != counts[key]):
            failures.append(f"{key.upper()} routes {by_route}: every launch should take {expected_bwd}, "
                            f"{wide} a step {K23_WIDE_ROUTE}")
    if dtype == torch.float32 and not ckpt_equal:
        failures.append("the best checkpoint does not reload into an equal model")
    if failures:
        raise AssertionError(f"{phase} {tname}: " + "; ".join(failures))
    del trainer, state, model
    torch.cuda.empty_cache()
    return line


def train_small_vs_cpu(torch, clm, flash, training, parallel):
    """(d) a small model whose pads reach into the latent window, one train
    step on the card (the kernels) against the same weights on the CPU with
    ``attention_impl="flash"`` (the plain forward and backward, with the same
    dead-row semantics)."""
    small = clm.CausalLanguageModelConfig(
        vocab_size=256, max_seq_len=64, max_latents=32, num_channels=128, num_heads=2,
        num_self_attention_layers=2, init_scale=0.1,
    )
    cpu = clm.CausalLanguageModel(small, device="cpu", seed=3, attention_impl="flash")
    card = clm.CausalLanguageModel(small, seed=0)
    card.load_state_dict(cpu.state_dict())
    batch = token_batches(256, 64, 3, 1, seed=41, pads=[0, 40, 50], distinct=256)[0]  # prefix 32: latents 0..17 dead
    out = {}
    reset_counts(flash)
    for name, model, dev in (("card", card, "cuda"), ("cpu", cpu, "cpu")):
        state = parallel.TrainState.create(model, training.make_optimizer(0.1, optimizer="sgd"))
        step = parallel.make_train_step(training.clm_loss_fn(model, 32), device=dev)
        state, metrics = step(state, batch, None)
        out[name] = (metrics["loss"].item(), {n: p.grad.detach().cpu() for n, p in model.named_parameters()},
                     {n: p.detach().cpu() for n, p in model.named_parameters()})
    counts = read_counts(flash)
    grad_err = max((out["card"][1][n] - g).abs().max().item() for n, g in out["cpu"][1].items())
    param_err = max((out["card"][2][n] - p).abs().max().item() for n, p in out["cpu"][2].items())
    emit("train_small_vs_cpu", loss_card=out["card"][0], loss_cpu=out["cpu"][0],
         grads_max_abs_err=grad_err, params_max_abs_err_after_sgd_step=param_err, tol=1e-4,
         card_launches=counts, dead_cross_rows=8 + 18)
    if not (grad_err <= 1e-4 and param_err <= 1e-4 and counts == {"k1": 3, "k2": 3, "k3": 3}):
        raise AssertionError(f"small model train step: grads {grad_err}, params {param_err}, launches {counts}")


def k4_refuses_grad(torch, ragged) -> None:
    """(e) K4 has no backward pass: a gradient request raises."""
    g = torch.Generator(device="cuda").manual_seed(9)
    q = torch.randn(1, 8, 1, 112, generator=g, device="cuda").requires_grad_()
    pool_k, pool_v = (torch.randn(32, 8, 112, generator=g, device="cuda") for _ in range(2))
    table = torch.tensor([[1, 0]], dtype=torch.int32, device="cuda")
    lengths = torch.tensor([5], dtype=torch.int32, device="cuda")
    message = None
    try:
        ragged.ragged_paged_attention(q, pool_k, pool_v, table, lengths, block_size=16)
    except RuntimeError as e:
        message = str(e)
    with torch.no_grad():
        o = ragged.ragged_paged_attention(q, pool_k, pool_v, table, lengths, block_size=16)
    torch.cuda.synchronize()
    emit("k4_grad_request", raised=message is not None, message=message,
         no_grad_finite=bool(torch.isfinite(o).all().item()))
    if message is None or "backward" not in message:
        raise AssertionError("K4 did not refuse a gradient request")


def train_phase(torch, clm, flash, ragged, training, parallel, root: Path):
    train_grad_gate(torch, clm, flash, training, parallel)
    cfg = clm_base_config(clm.CausalLanguageModelConfig)
    *train, held_out = token_batches(cfg.vocab_size, cfg.max_seq_len, 8, 3, seed=31)
    val = [{k: v[:4] for k, v in held_out.items()}]
    fits = {}
    for dtype in (torch.float32, torch.bfloat16):
        fits[str(dtype).split(".")[-1]] = train_fit(
            torch, flash, training, parallel, clm.CausalLanguageModel, cfg, dtype,
            root / str(dtype).split(".")[-1], train, train, val)
    train_small_vs_cpu(torch, clm, flash, training, parallel)
    k4_refuses_grad(torch, ragged)
    return fits


RESILIENCE_STEPS = 8
# the resume drill's periodic snapshots: at steps 4 and 8, beside the
# SIGTERM snapshot at 5 (each of clm-base with AdamW is 2.32 GB, ~3 s to
# write; every 2 steps wrote 9 where 5 hold the same path)
RESUME_SNAPSHOT_EVERY = 4
#: the depth of phase 14's (b)-(g) model: clm-base's widths over 4 of its 16
#: layers (each AdamW snapshot ~0.8 GB, not 2.32)
RESILIENCE_SNAPSHOT_LAYERS = 4
#: LAMB's peak rate in phase 14 (f); 1e-2 overshot (loss 11.14 -> 13.21 at step 6)
LAMB_LR = 5e-3
#: the gradient gates of phase 13 (a): fp32 within 1e-3 of each parameter's
#: largest entry, bf16 within 2 bf16 ulps (2^-7) of it, as K2/K3's gate
RESILIENCE_GRAD_TOL = {"float32": 1e-3, "bfloat16": 2.0 ** -7}


def set_checkpointing(model, checkpointing: bool, offloading: bool) -> None:
    """Turn activation checkpointing (and offloading) on or off in place."""
    model.perceiver_ar.activation_checkpointing = checkpointing
    model.perceiver_ar.activation_offloading = offloading


class IdTokenizer:
    """Text of space-separated token ids: lets the text-generation pipeline
    drive a model of any vocabulary (clm-base's 32000)."""

    pad_token_id = 0
    eos_token_id = None

    def encode(self, text: str) -> list:
        return [int(w) for w in text.split()]

    def decode(self, ids) -> str:
        return "".join(f" {int(i)}" for i in ids)


def _dev_sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _reset_peak(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


def _peak(torch, dev):
    return torch.cuda.max_memory_allocated() if dev.type == "cuda" else None


def _allocated(torch, dev):
    """Bytes allocated now: a peak's baseline (the sub-run's own peak is the
    peak above this)."""
    return torch.cuda.memory_allocated() if dev.type == "cuda" else None


def held_memory(torch) -> dict:
    """After a garbage collection: the bytes still allocated on the card and
    the largest live CUDA tensors by shape and type, to show what an earlier
    phase keeps."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    seen, by_kind = set(), {}
    for obj in gc.get_objects():
        if torch.is_tensor(obj) and obj.is_cuda and id(obj) not in seen:
            seen.add(id(obj))
            key = f"{tuple(obj.shape)} {str(obj.dtype).split('.')[-1]}"
            by_kind[key] = by_kind.get(key, 0) + obj.numel() * obj.element_size()
    largest = sorted(by_kind.items(), key=lambda kv: -kv[1])[:8]
    return dict(memory_allocated=torch.cuda.memory_allocated(), live_tensor_bytes=sum(by_kind.values()),
                largest=[{"tensor": k, "bytes": v} for k, v in largest])


def _route_counts(flash) -> dict:
    return {"k1": dict(flash.flash_attention.route_launches), **read_bwd_routes(flash)}


def _max_rel(grads, ref) -> dict:
    """Per parameter: ``max|g - ref| / max|ref|`` (0 where both are 0)."""
    out = {}
    for n, g in grads.items():
        diff, scale = (g - ref[n]).abs().max().item(), ref[n].abs().max().item()
        out[n] = diff / scale if scale > 0 else (0.0 if diff == 0 else math.inf)
    return out


def _fit_losses(root: Path) -> list:
    return [(r["step"], r["train/loss"]) for r in (json.loads(line) for line in open(root / "metrics.jsonl"))
            if "train/loss" in r]


def _trainer(training, model, cfg, root: Path, dev, *, optimizer="adamw", lr=1e-4, chaos=None,
             loss_fn=None, **overrides):
    """Phase 13's fit set-up: 8 steps, 2 microbatches, clipping 1.0,
    ``cosine_with_warmup`` (2 warmup steps), no validation unless asked."""
    schedule = training.cosine_with_warmup(lr, warmup_steps=2, training_steps=RESILIENCE_STEPS)
    kw = dict(max_steps=RESILIENCE_STEPS, val_check_interval=10_000, log_every_n_steps=1,
              grad_clip_norm=1.0, grad_accum_steps=2, enable_checkpointing=False,
              enable_tensorboard=False, default_root_dir=str(root))
    kw.update(overrides)
    return training.Trainer(training.TrainerConfig(**kw),
                            loss_fn or training.clm_loss_fn(model, cfg.max_latents),
                            training.make_optimizer(schedule, optimizer=optimizer), model_config=cfg,
                            lr_schedule=schedule, device=dev, chaos=chaos)


def resilience_checkpointing(torch, clm, flash, parallel, training, modules, dtype, cfg, dev) -> dict:
    """(a) One optimizer step's gradients (8 rows, 2 microbatches) in three
    modes over one model, batch and generator: plain, activation
    checkpointing, and checkpointing with offloading. Each mode runs once to
    warm, then three times timed (each ending in a synchronise; the p50 is
    ``step_ms``); launches are per step, the peak over the three."""
    tname = str(dtype).split(".")[-1]
    model = clm.CausalLanguageModel(cfg, dtype=dtype, seed=0, device=dev)
    state = parallel.TrainState.create(model, training.make_optimizer(1e-4))
    grads_step = parallel.make_gradient_step(training.clm_loss_fn(model, cfg.max_latents), grad_clip_norm=1.0,
                                             grad_accum_steps=2, device=dev)
    batch = token_batches(cfg.vocab_size, cfg.max_seq_len, 8, 1, seed=51)[0]
    elt = torch.finfo(dtype).bits // 8
    keep = (cfg.max_seq_len - cfg.max_latents) - int((cfg.max_seq_len - cfg.max_latents)
                                                      * cfg.cross_attention_dropout)
    # per microbatch of 4 rows: 17 layer inputs of (4, 512, 896), plus the kept prefix
    predicted = 2 * 4 * cfg.num_channels * elt * ((1 + cfg.num_self_attention_layers) * cfg.max_latents + keep)
    runs, ref, ref_loss = {}, None, None
    for mode, flags in (("plain", (False, False)), ("checkpointing", (True, False)),
                        ("offloading", (True, True))):
        set_checkpointing(model, *flags)
        grads_step(state, batch, torch.Generator(device=dev).manual_seed(7))
        model.zero_grad(set_to_none=True)
        reset_counts(flash)
        modules.reset_offload_counts()
        _reset_peak(torch, dev)
        start = _allocated(torch, dev)
        times = []
        for _ in range(3):
            _dev_sync(torch, dev)
            t0 = time.perf_counter()
            metrics = grads_step(state, batch, torch.Generator(device=dev).manual_seed(7))
            loss = metrics["loss"].item()
            _dev_sync(torch, dev)
            times.append((time.perf_counter() - t0) * 1e3)
        step_ms = sorted(times)[1]
        # per step: a count that is not a multiple of 3 shows as a fraction and fails
        totals = read_counts(flash)
        counts = {k: v / 3 for k, v in totals.items()}
        routes = {k: {r: n / 3 for r, n in v.items()} for k, v in _route_counts(flash).items()}
        peak = _peak(torch, dev)
        above = None if peak is None else peak - start
        offloaded = {k: v / 3 for k, v in modules.offload_counts.items()}
        grads = {n: p.grad.detach().to("cpu") for n, p in model.named_parameters()}
        if ref is None:
            ref, ref_loss = grads, loss
        rel = _max_rel(grads, ref)
        runs[mode] = dict(loss=loss, step_ms=step_ms, step_ms_runs=times, max_memory_allocated=peak,
                          memory_allocated_at_start=start, peak_above_start=above,
                          launches_3_steps=totals, launches=counts,
                          route_launches=routes, offloaded=offloaded, max_rel_grad_err=max(rel.values()),
                          loss_rel_err=abs(loss - ref_loss) / abs(ref_loss))
        emit("train_resilience", part="checkpointing", compute_dtype=tname, mode=mode, rows=8,
             grad_accum_steps=2, **runs[mode], offload_predicted_bytes=predicted if flags[1] else 0)
    set_checkpointing(model, False, False)
    failures = []
    for mode, run in runs.items():
        if run["max_rel_grad_err"] > RESILIENCE_GRAD_TOL[tname] or run["loss_rel_err"] > 1e-5:
            failures.append(f"{mode}: grads {run['max_rel_grad_err']}, loss {run['loss_rel_err']}")
        if dev.type == "cuda":
            k1 = 34 if mode == "plain" else 68
            if run["launches"] != {"k1": k1, "k2": 34, "k3": 34}:
                failures.append(f"{mode}: launches {run['launches']}")
            design = "wgmma" if dtype == torch.bfloat16 else "tf32x3"
            for key, by_route in run["route_launches"].items():
                if by_route[design] != run["launches"][key]:
                    failures.append(f"{mode}: {key} routes {by_route}, all should take {design}")
    # per microbatch: the cross layer's latents and kept prefix, each stack layer's input
    layer_inputs = 2 * (2 + cfg.num_self_attention_layers)
    if (runs["offloading"]["offloaded"] != {"tensors": layer_inputs, "bytes": predicted}
            or runs["checkpointing"]["offloaded"]["tensors"]):
        failures.append(f"offloaded {runs['offloading']['offloaded']} against {layer_inputs} tensors, "
                        f"{predicted} bytes predicted")
    if dev.type == "cuda":
        peaks = [runs[m]["peak_above_start"] for m in ("plain", "checkpointing", "offloading")]
        if not peaks[0] > peaks[1] >= peaks[2]:
            failures.append(f"peak memory above the start, plain/checkpointing/offloading {peaks}")
    if failures:
        raise AssertionError(f"train_resilience checkpointing {tname}: " + "; ".join(failures))
    del model, state, ref, grads
    return {mode: run["launches_3_steps"] for mode, run in runs.items()}


def resilience_dropout(torch, clm, flash, parallel, training, cfg, root: Path, dev) -> dict:
    """(b) ``Trainer.fit`` with attention and residual dropout 0.1 (fp32):
    the loss falls, no K1/K2/K3 in the training steps (every train-mode
    attend takes the plain path, as JAX's dispatch does), K1 in the
    deterministic validation pass; then one step's gradients with and
    without checkpointing under one generator."""
    import dataclasses

    cfg = dataclasses.replace(cfg, post_attention_dropout=0.1, residual_dropout=0.1)
    model = clm.CausalLanguageModel(cfg, seed=0, device=dev)
    trainer = _trainer(training, model, cfg, root, dev, val_check_interval=RESILIENCE_STEPS,
                       limit_val_batches=1)
    *train, held_out = token_batches(cfg.vocab_size, cfg.max_seq_len, 8, 3, seed=31)
    val = [{k: v[:4] for k, v in held_out.items()}]
    validate, val_counts = trainer.validate, {"k1": 0, "k2": 0, "k3": 0}

    def counted_validate(data):
        before = read_counts(flash)
        out = validate(data)
        for key, n in read_counts(flash).items():
            val_counts[key] += n - before[key]
        return out

    trainer.validate = counted_validate
    _reset_peak(torch, dev)
    start = _allocated(torch, dev)
    reset_counts(flash)
    _dev_sync(torch, dev)
    t0 = time.perf_counter()
    trainer.fit(model, train, val_data=lambda: iter(val))
    _dev_sync(torch, dev)
    fit_s = time.perf_counter() - t0
    counts = read_counts(flash)
    train_counts = {k: counts[k] - val_counts[k] for k in counts}
    losses = [loss for _, loss in _fit_losses(root)]
    peak = _peak(torch, dev)

    grads_step = parallel.make_gradient_step(trainer.loss_fn, grad_clip_norm=1.0, grad_accum_steps=2, device=dev)
    grads = {}
    for mode, flag in (("plain", False), ("checkpointing", True)):
        set_checkpointing(model, flag, False)
        grads_step(trainer.state, train[0], torch.Generator(device=dev).manual_seed(13))
        grads[mode] = {n: p.grad.detach().to("cpu") for n, p in model.named_parameters()}
    set_checkpointing(model, False, False)
    rel = max(_max_rel(grads["checkpointing"], grads["plain"]).values())
    line = dict(compute_dtype="float32", post_attention_dropout=0.1, residual_dropout=0.1, steps=RESILIENCE_STEPS,
                losses=losses, fit_s=fit_s, step_ms=fit_s * 1e3 / RESILIENCE_STEPS, max_memory_allocated=peak,
                memory_allocated_at_start=start, peak_above_start=None if peak is None else peak - start,
                launches=train_counts, validation_launches=val_counts, route_launches=_route_counts(flash),
                checkpointing_max_rel_grad_err=rel)
    emit("train_resilience", part="dropout", **line)
    failures = []
    if not (len(losses) == RESILIENCE_STEPS and all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]):
        failures.append(f"losses {losses}")
    if dev.type == "cuda" and (train_counts != {"k1": 0, "k2": 0, "k3": 0}
                        or val_counts != {"k1": 1 + cfg.num_self_attention_layers, "k2": 0, "k3": 0}):
        failures.append(f"training launches {train_counts}, validation {val_counts}")
    if rel > RESILIENCE_GRAD_TOL["float32"]:
        failures.append(f"checkpointed gradients off by {rel}")
    if failures:
        raise AssertionError("train_resilience dropout: " + "; ".join(failures))
    del trainer, model, grads
    return {"launches": train_counts, "validation_launches": val_counts}


def resilience_resume(torch, clm, flash, training, cfg, root: Path, dev) -> dict:
    """(c) An uninterrupted 8-step fit with a snapshot every
    ``RESUME_SNAPSHOT_EVERY`` steps; a second fit into a fresh root whose
    loss function raises SIGTERM at the process during step 5 (in the main
    thread), so the trainer finishes that step, snapshots and returns; a
    third trainer resumes it to step 8. The stitched losses equal the
    uninterrupted run's bit for bit."""
    import signal

    train = token_batches(cfg.vocab_size, cfg.max_seq_len, 8, 2, seed=31)
    out = {}
    reset_counts(flash)

    def fit(name, sub: Path, **kw):
        model = clm.CausalLanguageModel(cfg, seed=0, device=dev)
        loss_fn = kw.pop("wrap", lambda f: f)(training.clm_loss_fn(model, cfg.max_latents))
        trainer = _trainer(training, model, cfg, sub, dev, save_state_every_n_steps=RESUME_SNAPSHOT_EVERY,
                           loss_fn=loss_fn, **kw)
        _dev_sync(torch, dev)
        t0 = time.perf_counter()
        state = trainer.fit(model, train)
        _dev_sync(torch, dev)
        out[name] = dict(fit_s=time.perf_counter() - t0, step=state.step,
                         snapshots=training.ResumeCheckpointManager(str(sub / "resume")).steps())
        del trainer, state, model
        if dev.type == "cuda":
            torch.cuda.empty_cache()

    fit("uninterrupted", root / "a")
    calls = [0]

    def preempt_at_step_5(loss_fn):
        def wrapped(model, batch, generator):
            calls[0] += 1
            if calls[0] == 2 * 4 + 1:  # the first microbatch of step 5
                signal.raise_signal(signal.SIGTERM)
            return loss_fn(model, batch, generator)
        return wrapped

    previous = signal.getsignal(signal.SIGTERM)
    fit("preempted", root / "b", wrap=preempt_at_step_5)
    handler_restored = signal.getsignal(signal.SIGTERM) == previous
    fit("resumed", root / "b", resume=str(root / "b"))
    straight, stitched = _fit_losses(root / "a"), _fit_losses(root / "b")
    snapshot = root / "a" / "resume" / str(out["uninterrupted"]["snapshots"][-1]) / "state.pt"
    line = dict(runs=out, uninterrupted_losses=[x for _, x in straight], stitched_losses=[x for _, x in stitched],
                equal=stitched == straight, max_abs_diff=max(abs(a[1] - b[1]) for a, b in zip(straight, stitched))
                if len(straight) == len(stitched) else None, snapshot_bytes=snapshot.stat().st_size,
                handler_restored=handler_restored, launches=read_counts(flash))
    emit("train_resilience", part="resume", **line)
    if (stitched != straight or out["preempted"]["step"] != 5 or 5 not in out["preempted"]["snapshots"]
            or out["resumed"]["step"] != RESILIENCE_STEPS or not handler_restored):
        raise AssertionError(f"train_resilience resume: stitched {stitched} against {straight}; runs {out}")
    shutil.rmtree(root / "a", ignore_errors=True)
    shutil.rmtree(root / "b", ignore_errors=True)
    return {"launches": line["launches"]}


def resilience_recovery(torch, clm, flash, training, reliability, cfg, root: Path, dev) -> dict:
    """(d) Under a ``ChaosRegistry``: ``skip`` with one NaN loss at step 3,
    and ``rollback`` with three in a row from step 3 (snapshots every 2
    steps), over 6 steps each."""
    train = token_batches(cfg.vocab_size, cfg.max_seq_len, 8, 2, seed=31)
    runs = {}
    reset_counts(flash)
    for policy, count in (("skip", 1), ("rollback", 3)):
        chaos = reliability.ChaosRegistry()
        chaos.nan_loss_at_step(3, count=count)
        model = clm.CausalLanguageModel(cfg, seed=0, device=dev)
        extra = {"save_state_every_n_steps": 2} if policy == "rollback" else {}
        trainer = _trainer(training, model, cfg, root / policy, dev, chaos=chaos, max_steps=6,
                           non_finite_policy=policy, **extra)
        t0 = time.perf_counter()
        state = trainer.fit(model, train)
        _dev_sync(torch, dev)
        rows = [json.loads(line) for line in open(root / policy / "metrics.jsonl")]
        losses = [r["train/loss"] for r in rows if "train/loss" in r]
        runs[policy] = dict(fault_stats=dict(trainer.fault_stats), step=state.step, losses=losses,
                            rollback_to=[r["rollback_to_step"] for r in rows if "rollback_to_step" in r],
                            fired=chaos.fired_count("trainer.step"), fit_s=time.perf_counter() - t0)
        del trainer, state, model
        shutil.rmtree(root / policy, ignore_errors=True)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    emit("train_resilience", part="recovery", **runs, launches=read_counts(flash))
    skip, rollback = runs["skip"], runs["rollback"]
    if not (skip["fault_stats"]["skipped_steps"] == 1 and skip["step"] == 5 and math.isfinite(skip["losses"][-1])
            and rollback["fault_stats"]["rollbacks"] == 1 and rollback["rollback_to"] == [2]
            and rollback["step"] == 6 and math.isfinite(rollback["losses"][-1])):
        raise AssertionError(f"train_resilience recovery: {runs}")
    return {"launches": read_counts(flash)}


def resilience_steps_per_execution(torch, clm, flash, training, cfg, root: Path, dev) -> dict:
    """(e) The same 8 steps with ``steps_per_execution`` 1 and 4: each block's
    logged loss is the mean of the single steps' four, and the parameters
    end equal."""
    import numpy as np

    train = token_batches(cfg.vocab_size, cfg.max_seq_len, 8, 2, seed=31)
    runs, models = {}, {}
    for spe in (1, 4):
        model = clm.CausalLanguageModel(cfg, seed=0, device=dev)
        trainer = _trainer(training, model, cfg, root / f"spe{spe}", dev, steps_per_execution=spe,
                           log_every_n_steps=spe)
        reset_counts(flash)
        _dev_sync(torch, dev)
        t0 = time.perf_counter()
        trainer.fit(model, train)
        _dev_sync(torch, dev)
        fit_s = time.perf_counter() - t0
        runs[spe] = dict(fit_s=fit_s, ms_per_step=fit_s * 1e3 / RESILIENCE_STEPS,
                         losses=_fit_losses(root / f"spe{spe}"), launches=read_counts(flash))
        models[spe] = model
        del trainer
    singles = [x for _, x in runs[1]["losses"]]
    means = [(4 * (i + 1), float(np.mean(singles[4 * i:4 * i + 4]))) for i in range(2)]
    params_equal = all(torch.equal(a, b) for a, b in zip(models[1].parameters(), models[4].parameters()))
    emit("train_resilience", part="steps_per_execution", ms_per_step={s: r["ms_per_step"] for s, r in runs.items()},
         single_losses=singles, block_losses=runs[4]["losses"], single_block_means=means,
         params_equal=params_equal, launches={s: r["launches"] for s, r in runs.items()})
    if runs[4]["losses"] != means or not params_equal or runs[1]["launches"] != runs[4]["launches"]:
        raise AssertionError(f"train_resilience steps_per_execution: {runs}, means {means}, params {params_equal}")
    del models
    return {"launches": runs[4]["launches"]}


def resilience_lamb(torch, clm, flash, training, cfg, root: Path, dev):
    """(f) An 8-step LAMB fit (fp32, 5e-3 with warmup; a weight of the 0.02
    init scale then moves ~1e-4 a step, as under phase 13's AdamW at 1e-4):
    the loss falls. Then
    one LAMB update of the fitted parameters with their last gradients and
    moments on the card, against the same update on CPU copies."""
    model = clm.CausalLanguageModel(cfg, seed=0, device=dev)
    trainer = _trainer(training, model, cfg, root / "lamb", dev, optimizer="lamb", lr=LAMB_LR)
    train = token_batches(cfg.vocab_size, cfg.max_seq_len, 8, 2, seed=31)
    reset_counts(flash)
    _dev_sync(torch, dev)
    t0 = time.perf_counter()
    state = trainer.fit(model, train)
    _dev_sync(torch, dev)
    fit_s = time.perf_counter() - t0
    launches = read_counts(flash)
    losses = [x for _, x in _fit_losses(root / "lamb")]
    opt = state.optimizer
    cpu_params = [p.detach().cpu().requires_grad_() for p in model.parameters()]
    for c, p in zip(cpu_params, model.parameters()):
        c.grad = p.grad.detach().cpu()
    cpu_opt = training.Lamb(cpu_params, lr=opt.param_groups[0]["lr"], eps=1e-6)
    cpu_opt.load_state_dict(opt.state_dict())
    opt.step()
    cpu_opt.step()
    rel = max((p.detach().cpu() - c.detach()).abs().max().item() / max(c.detach().abs().max().item(), 1e-30)
              for p, c in zip(model.parameters(), cpu_params))
    emit("train_resilience", part="lamb", compute_dtype="float32", lr=LAMB_LR, losses=losses, fit_s=fit_s,
         step_ms=fit_s * 1e3 / RESILIENCE_STEPS, card_vs_cpu_update_max_rel_err=rel, tol=1e-5, launches=launches)
    if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]) or rel > 1e-5:
        raise AssertionError(f"train_resilience lamb: losses {losses}, card vs CPU update {rel}")
    del trainer, state, opt, cpu_opt, cpu_params
    return model, launches


def resilience_pretrained(torch, clm, flash, training, pipelines_mod, model, cfg, root: Path, dev):
    """(g) ``save_pretrained`` of the LAMB fit's model, then
    ``pipeline_from_pretrained`` on the card over a token-id tokenizer: its
    text equals the direct pipeline's over the live model (fp32); with bf16
    compute and weights the text equals a direct bf16 model's and K1 takes
    ``wgmma``."""
    path = root / "pretrained"
    training.save_pretrained(str(path), model, cfg)
    tok = IdTokenizer()
    batch = token_batches(cfg.vocab_size, min(600, cfg.max_seq_len // 2), 2, 1, seed=61)[0]["input_ids"]
    prompts = [" ".join(str(int(t)) for t in row) for row in batch]
    kw = dict(max_new_tokens=8, num_latents=min(64, cfg.max_latents))
    direct = pipelines_mod.pipeline("text-generation", model, tok, device=dev)(prompts, **kw)
    reset_counts(flash)
    loaded = pipelines_mod.pipeline_from_pretrained("text-generation", str(path), tok, device=dev)(prompts, **kw)
    fp32_routes = dict(flash.flash_attention.route_launches)
    half = clm.CausalLanguageModel(cfg, dtype=torch.bfloat16, seed=1, device=dev)
    half.load_state_dict(model.state_dict())
    pipelines_mod.cast_float_params(half, torch.bfloat16)
    direct16 = pipelines_mod.pipeline("text-generation", half, tok, device=dev)(prompts, **kw)
    reset_counts(flash)
    loaded16 = pipelines_mod.pipeline_from_pretrained("text-generation", str(path), tok, dtype=torch.bfloat16,
                                                      params_dtype=torch.bfloat16, device=dev)(prompts, **kw)
    bf16_routes = dict(flash.flash_attention.route_launches)
    agree = [sum(a == b for a, b in zip(x[len(p):].split(), y[len(p):].split()))
             for x, y, p in zip(loaded, loaded16, prompts)]
    emit("train_resilience", part="pretrained", bytes=(path / "model.pt").stat().st_size, prompts=len(prompts),
         fp32_equal=loaded == direct, bf16_equal=loaded16 == direct16, k1_routes_fp32=fp32_routes,
         k1_routes_bf16=bf16_routes, bf16_tokens_agreeing_with_fp32=agree,
         continuations=[t[len(p):] for t, p in zip(loaded, prompts)])
    wrong_routes = dev.type == "cuda" and (bf16_routes["wgmma"] == 0 or bf16_routes["tf32x3"]
                                           or fp32_routes["tf32x3"] == 0)
    if loaded != direct or loaded16 != direct16 or wrong_routes:
        raise AssertionError(f"train_resilience pretrained: fp32 {loaded!r} against {direct!r}, bf16 "
                             f"{loaded16!r} against {direct16!r}, K1 routes {fp32_routes} / {bf16_routes}")
    shutil.rmtree(path, ignore_errors=True)
    del half
    return {"fp32": fp32_routes, "bf16": bf16_routes}


def train_resilience_phase(torch, clm, flash, parallel, training, modules, reliability, pipelines_mod,
                           root: Path, cfg=None, dev=None) -> dict:
    """Phase 14 (module docstring). Returns each sub-run's launches."""
    import dataclasses

    cfg = cfg or clm_base_config(clm.CausalLanguageModelConfig)
    dev = dev or torch.device("cuda")
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    launches = {}
    for dtype in (torch.float32, torch.bfloat16):
        runs = resilience_checkpointing(torch, clm, flash, parallel, training, modules, dtype, cfg, dev)
        for mode, counts in runs.items():
            launches[f"checkpointing_{str(dtype).split('.')[-1]}_{mode}"] = counts
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    # (b)-(g) at clm-base's widths over fewer layers: the snapshots'
    # writes were the phase's longest part, and (b), (e)-(g) hold the same
    # gates over 4 layers as over 16 (their launch counts follow the depth)
    shallow = dataclasses.replace(cfg, num_self_attention_layers=min(RESILIENCE_SNAPSHOT_LAYERS,
                                                                     cfg.num_self_attention_layers))
    launches["dropout"] = resilience_dropout(torch, clm, flash, parallel, training, shallow, root / "dropout",
                                             dev)["launches"]
    launches["resume"] = resilience_resume(torch, clm, flash, training, shallow, root / "resume",
                                           dev)["launches"]
    launches["recovery"] = resilience_recovery(torch, clm, flash, training, reliability, shallow,
                                               root / "recovery", dev)["launches"]
    launches["steps_per_execution_4"] = resilience_steps_per_execution(
        torch, clm, flash, training, shallow, root / "spe", dev)["launches"]
    model, launches["lamb"] = resilience_lamb(torch, clm, flash, training, shallow, root, dev)
    resilience_pretrained(torch, clm, flash, training, pipelines_mod, model, shallow, root, dev)
    del model
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    shutil.rmtree(root, ignore_errors=True)
    return launches


# the symbolic-audio phase: the GiantMIDI model (docs/pretrained-models.md,
# examples/training/sam.sh): 6144 context, 2048 latents, 768 channels over 8
# heads (d = 96), 12 layers, the 389-event vocabulary
SAM_LATENTS = 2032  # 16 latent-growth steps before the boundary, as phases 5 and 7
#: the depth of phase 15's (b)-(e) and of the cli phase's symbolic fit
SYMBOLIC_LAYERS = 4
SAM_BUCKETS = (3072, 6120)  # 6120 - 2032 = 4088 prefix slots (<= 4096); +24 tokens reach the window
SAM_SLOT_BUCKETS = (3072, 4608, 6048)  # 6048 <= max_prefix_len + latents = 4096 + 2032
SAM_LR = 2e-4  # examples/training/sam.sh's peak, reached after the warmup
# sam.sh's schedule is cosine with a warmup (500 of 50000 steps); at 2e-4
# from the first step AdamW overshot (bf16 loss 6.30 -> 6.90 at step 3,
# 6.38 at step 8 on an NVIDIA H100 80GB HBM3), so the fit warms up over
# half its steps
SAM_WARMUP = 4
SAM_SAMPLE = dict(do_sample=True, temperature=1.0, top_k=15)


#: phase 14b's meshes over two ranks sharing one card, in order:
#: (name, axis sizes, attention_impl, shard_seq, optimizer)
MESH_CASES = (("data2", {"data": 2}, "auto", False, "adamw"),
              ("fsdp2", {"data": 1, "fsdp": 2}, "auto", False, "adamw"),
              ("model2", {"data": 1, "model": 2}, "auto", False, "adamw"),
              ("seq2", {"data": 1, "seq": 2}, "ring", True, "adamw"),
              ("fsdp2_lamb", {"data": 1, "fsdp": 2}, "auto", False, "lamb"),
              ("model2_lamb", {"data": 1, "model": 2}, "auto", False, "lamb"))
MESH_STEPS = 3
#: two microbatches a step: 34 K1/K2/K3 launches a step, as phase 13's fits
MESH_ACCUM = 2
MESH_DROPOUT = 0.5
#: rank 0's losses against the single-rank trajectory (JAX's bar)
MESH_RTOL = 2e-4
MESH_RANK_TIMEOUT_S = 600
#: the device every rank computes on, and the backends of (a) and (b)
MESH_DEVICE = "cuda:0"
MESH_BACKENDS = {"world1": "nccl", "world2": "gloo"}


def mesh_config(clm):
    return dataclasses.replace(clm_base_config(clm.CausalLanguageModelConfig), cross_attention_dropout=MESH_DROPOUT)


def mesh_trajectory(torch, clm, flash, parallel, training, mesh, cfg, dev, impl: str = "auto",
                    shard_seq: bool = False, keep_params: bool = False, optimizer: str = "adamw") -> dict:
    """``MESH_STEPS`` steps of ``optimizer`` (lr 1e-4) over ``cfg`` (prefix dropout 0.5, each
    step's generator from ``(0, step)``) on ``mesh`` (None: the single-rank
    step on ``dev``): losses, K1/K2/K3 launches by route and collective
    calls and bytes by kind a step, step ms (a host clock around a step
    ending in a synchronise), peak ``max_memory_allocated``."""
    from perceiver_io_tpu_torch.parallel import collectives
    from perceiver_io_tpu_torch.training.trainer import step_generator

    model = clm.CausalLanguageModel(cfg, seed=0, device=dev, attention_impl=impl)
    n_params = sum(p.numel() for p in model.parameters())
    tx = training.make_optimizer(1e-4, optimizer=optimizer)
    if mesh is None:
        state = parallel.TrainState.create(model, tx)
    else:
        state, _ = parallel.create_train_state(model, tx, mesh)
    step = parallel.make_train_step(training.clm_loss_fn(model, cfg.max_latents), grad_clip_norm=1.0,
                                    grad_accum_steps=MESH_ACCUM, mesh=mesh, shard_seq=shard_seq, device=dev)
    out = {"losses": [], "launches": [], "collectives": [], "step_ms": [], "n_params": n_params}
    _reset_peak(torch, dev)
    for i, batch in enumerate(token_batches(cfg.vocab_size, cfg.max_seq_len, 8, MESH_STEPS, seed=61)):
        if mesh is not None:
            batch = parallel.shard_batch(batch, mesh, shard_seq=shard_seq)
        reset_counts(flash)
        collectives.reset_counts()
        _dev_sync(torch, dev)
        t0 = time.perf_counter()
        state, metrics = step(state, batch, step_generator(0, i, dev))
        out["losses"].append(metrics["loss"].item())
        _dev_sync(torch, dev)
        out["step_ms"].append((time.perf_counter() - t0) * 1e3)
        out["launches"].append(_route_counts(flash))
        out["collectives"].append(collectives.read_counts())
    out["peak_bytes"] = _peak(torch, dev)
    if keep_params:  # on the device (a world of one holds whole parameters)
        out["params"] = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    del state, model, step
    _reset_peak(torch, dev)
    return out


def mesh_rank_main(argv) -> int:
    """A rank of phase 14b (``python3 chip_smoke.py --mesh-rank rank world
    job_dir``): joins the world ``job_dir/job.json`` names (over a
    ``file://`` store there), runs its cases and writes
    ``rank<r>.json``."""
    import torch

    rank, world, job_dir = int(argv[0]), int(argv[1]), Path(argv[2])
    sys.path.insert(0, str(ROOT))
    from perceiver_io_tpu_torch import _build, parallel, training
    from perceiver_io_tpu_torch.models.text import clm
    from perceiver_io_tpu_torch.ops import flash_attention as flash
    from perceiver_io_tpu_torch.parallel import multihost

    job = json.loads((job_dir / "job.json").read_text())
    dev = torch.device(job["device"])
    missing = [n for n in _build.sources() if not _build._target(n).exists()]
    if dev.type == "cuda" and missing:  # a rank loads what phase 2 built; two ranks must not build at once
        raise RuntimeError(f"mesh rank {rank}: kernels not built: {missing}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = clm.CausalLanguageModelConfig(**job["config"])
    if dev.type == "cuda":
        torch.cuda.init()  # the context comes up while an earlier world still runs
    while not (job_dir / "go").exists():  # the parent's signal that the card is free
        time.sleep(0.05)
    multihost.initialize(f"file://{job_dir / 'store'}", world, rank, backend=job["backend"], device=dev)
    results = {}
    if job.get("shard_prompts"):  # phase 14c's (a), before the training cases
        from perceiver_io_tpu_torch.inference import generate as gen_mod
        from perceiver_io_tpu_torch.ops import ragged_attention as ragged
        from perceiver_io_tpu_torch.serving import buckets
        from perceiver_io_tpu_torch.serving import sharding as sharding_mod
        from perceiver_io_tpu_torch.serving import slots as slots_mod

        results["shard_a"] = shard_world_one(torch, clm, flash, ragged, gen_mod, slots_mod, buckets, sharding_mod,
                                             clm_base_config(clm.CausalLanguageModelConfig),
                                             job["shard_prompts"], dev)
    for name, sizes, impl, shard_seq, optimizer in job["cases"]:
        mesh = parallel.make_mesh(parallel.MeshConfig(**sizes), device=dev)
        if name == "world1":  # (a): the no-mesh steps and the world-of-one mesh, in this process
            plain = mesh_trajectory(torch, clm, flash, parallel, training, None, cfg, dev, keep_params=True)
            meshed = mesh_trajectory(torch, clm, flash, parallel, training, mesh, cfg, dev, keep_params=True)
            same = [n for n, v in plain.pop("params").items() if torch.equal(v, meshed["params"][n])]
            n_params = len(meshed.pop("params"))
            _reset_peak(torch, dev)
            lamb = mesh_trajectory(torch, clm, flash, parallel, training, None, cfg, dev, optimizer="lamb")
            results[name] = {**meshed, "plain": plain, "plain_lamb": lamb, "params_bit_equal": len(same),
                             "params": n_params}
        else:
            results[name] = mesh_trajectory(torch, clm, flash, parallel, training, mesh, cfg, dev, impl, shard_seq,
                                            optimizer=optimizer)
    (job_dir / f"rank{rank}.json").write_text(json.dumps(results))
    multihost.shutdown()
    return 0


def start_mesh_ranks(world: int, backend: str, cases, cfg, job_dir: Path, shard_prompts=None) -> tuple:
    """Spawn ``world`` ranks of :func:`mesh_rank_main` over ``cases`` (and
    phase 14c's (a) over ``shard_prompts``); they start (imports, CUDA
    context) and wait for :func:`finish_mesh_ranks`."""
    shutil.rmtree(job_dir, ignore_errors=True)
    job_dir.mkdir(parents=True)
    (job_dir / "job.json").write_text(json.dumps({"backend": backend, "cases": cases, "device": MESH_DEVICE,
                                                  "config": dataclasses.asdict(cfg),
                                                  "shard_prompts": shard_prompts}))
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    logs = [open(job_dir / f"rank{r}.log", "w") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--mesh-rank", str(r), str(world),
                               str(job_dir)], cwd=str(ROOT), env=env, stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(world)]
    return procs, logs, job_dir, backend


def finish_mesh_ranks(started: tuple) -> list:
    """Let the ranks of :func:`start_mesh_ranks` run and return each rank's
    results; a rank that fails (or outlives ``MESH_RANK_TIMEOUT_S``) stops
    every rank and raises."""
    procs, logs, job_dir, backend = started
    world = len(procs)
    (job_dir / "go").touch()
    deadline = time.monotonic() + MESH_RANK_TIMEOUT_S
    try:
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline or any(p.returncode not in (None, 0) for p in procs):
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if failed:
        tails = "\n".join(f"--- rank {r} (exit {procs[r].returncode}):\n"
                          + (job_dir / f"rank{r}.log").read_text()[-4000:] for r in failed)
        raise AssertionError(f"mesh phase: ranks {failed} of a {backend} world of {world} failed:\n{tails}")
    return [json.loads((job_dir / f"rank{r}.json").read_text()) for r in range(world)]


def finish_mesh_ranks_abort(started: tuple) -> None:
    """Stop ranks that were started but will not be let run."""
    procs, logs = started[0], started[1]
    for p in procs:
        p.kill()
        p.wait()
    for f in logs:
        f.close()


def _per_step(launches: list) -> dict:
    """K1/K2/K3 launches by route, per step (every step the same, or a list)."""
    first = launches[0]
    return first if all(x == first for x in launches) else {"per_step": launches}


def mesh_launches(mesh: dict, kernel: str) -> dict:
    """Phase 14b's launches a step of ``kernel`` (``k1``, ``k2``, ``k3``) by
    route per mesh and rank."""
    return {name: [_per_step([step[kernel] for step in rank["launches"]]) for rank in ranks]
            for name, ranks in mesh["ranks"].items()}


def mesh_phase(torch, clm, flash, parallel, training, root: Path, smi: str) -> dict:
    """Phase 14b (module docstring)."""
    failures = []
    cfg = mesh_config(clm)
    want = {"tf32x3": MESH_ACCUM * (1 + cfg.num_self_attention_layers)}
    # (a) in one NCCL rank: the single-rank trajectory (every mesh's
    # reference) and the world-of-one mesh; (b)'s ranks start meanwhile and
    # wait for the card
    first = start_mesh_ranks(1, MESH_BACKENDS["world1"], [["world1", {"data": 1}, "auto", False, "adamw"]], cfg,
                             root / "world1", shard_prompts=shard_workload())
    second = start_mesh_ranks(2, MESH_BACKENDS["world2"], [list(c) for c in MESH_CASES], cfg, root / "world2")
    try:
        (one,) = finish_mesh_ranks(first)
    except BaseException:
        finish_mesh_ranks_abort(second)
        raise
    w1 = one["world1"]
    ref = w1["plain"]
    refs = {"adamw": ref, "lamb": w1["plain_lamb"]}
    ranks = {"single_rank": [ref], "single_rank_lamb": [refs["lamb"]], "world1": [w1]}
    for case, run in (("single_rank", ref), ("single_rank_lamb", refs["lamb"])):
        emit("mesh", case=case, losses=run["losses"], step_ms=run["step_ms"],
             step_ms_p50=_p50(run["step_ms"]), peak_bytes=run["peak_bytes"], nvidia_smi=smi,
             launches_per_step=_per_step([{k: s[k] for k in ("k1", "k2", "k3")} for s in run["launches"]]))
    for run in (ref, refs["lamb"], w1):
        for s in run["launches"]:
            for k in ("k1", "k2", "k3"):
                if {r: n for r, n in s[k].items() if n} != want:
                    failures.append(f"single-rank {k} launches {s[k]}, want {want}")
    if w1["losses"] != ref["losses"] or w1["params_bit_equal"] != w1["params"]:
        failures.append(f"world of one: losses {w1['losses']} vs no-mesh {ref['losses']}, "
                        f"{w1['params_bit_equal']} of {w1['params']} parameters bit-equal")
    two = finish_mesh_ranks(second)
    n_params = ref["n_params"]
    for name, sizes, impl, _, optimizer in MESH_CASES:
        ranks[name] = [r[name] for r in two]
        r0 = ranks[name][0]
        single = refs[optimizer]
        rel = max(abs(a - b) / abs(b) for a, b in zip(r0["losses"], single["losses"]))
        if rel > MESH_RTOL:
            failures.append(f"{name}: losses {r0['losses']} vs single-rank {single['losses']} (rel {rel:.3g})")
        for rank, res in enumerate(ranks[name]):
            if res["losses"] != r0["losses"]:
                failures.append(f"{name}: rank {rank}'s losses {res['losses']} vs rank 0's {r0['losses']}")
            for s in res["launches"]:
                for k in ("k1", "k2", "k3"):
                    got = {r: n for r, n in s[k].items() if n}
                    if got != ({} if impl == "ring" else want):
                        failures.append(f"{name} rank {rank}: {k} launches {s[k]}")
            comm = res["collectives"][-1]
            base = name.removesuffix("_lamb")
            present = {"data2": comm["all_reduce"]["bytes"] >= 4 * n_params,
                       # an all-gather a sharded parameter a microbatch (and the
                       # microbatches' regrouping of the batch), a reduce-scatter each
                       "fsdp2": 0 < comm["reduce_scatter"]["calls"] <= comm["all_gather"]["calls"],
                       "model2": comm["all_reduce"]["calls"] > 0,
                       "seq2": comm["send_recv"]["calls"] > 0
                       and comm["send_recv"]["host_staged"] == comm["send_recv"]["calls"]}[base]
            if not present:
                failures.append(f"{name} rank {rank}: collectives {comm}")
            lamb = {}
            if optimizer == "lamb":
                # the trust ratios' whole norms: one all-reduce of the shards'
                # squared norms (every sharded parameter's over one axis) a step
                adamw = ranks[base][rank]["collectives"][-1]["all_reduce"]
                lamb = dict(norm_all_reduces_per_step=comm["all_reduce"]["calls"] - adamw["calls"],
                            norm_all_reduce_bytes_per_step=comm["all_reduce"]["bytes"] - adamw["bytes"],
                            adamw_step_ms_p50=_p50(ranks[base][rank]["step_ms"]))
                if lamb["norm_all_reduces_per_step"] != 1:
                    failures.append(f"{name} rank {rank}: {lamb['norm_all_reduces_per_step']} norm all-reduces "
                                    f"a step, want 1")
            emit("mesh", case=name, rank=rank, mesh=sizes, optimizer=optimizer, **lamb,
                 backend=MESH_BACKENDS["world2"], device=MESH_DEVICE,
                 transport="gloo on one card: all_reduce / all_gather / reduce_scatter / broadcast take the "
                           "CUDA tensors; ring send_recv staged through host memory",
                 losses=res["losses"], single_rank_losses=single["losses"], max_rel=rel,
                 launches_per_step=_per_step([{k: s[k] for k in ("k1", "k2", "k3")} for s in res["launches"]]),
                 collectives_per_step=res["collectives"][-1], step_ms=res["step_ms"],
                 step_ms_p50=_p50(res["step_ms"]), peak_bytes=res["peak_bytes"], nvidia_smi=smi)
    emit("mesh", case="world1", backend=MESH_BACKENDS["world1"], device=MESH_DEVICE, losses=w1["losses"],
         plain_losses=ref["losses"], params_bit_equal=w1["params_bit_equal"], params=w1["params"],
         step_ms_p50=_p50(w1["step_ms"]), peak_bytes=w1["peak_bytes"],
         launches_per_step=_per_step([{k: s[k] for k in ("k1", "k2", "k3")} for s in w1["launches"]]),
         nvidia_smi=smi)
    if failures:
        raise AssertionError("mesh phase: " + "; ".join(failures[:12]))
    return {"ranks": ranks, "single_rank": ref, "single_rank_lamb": refs["lamb"], "shard_a": one["shard_a"]}


# -- phase 14c: the sharded slot engine ----------------------------------------
#: (b)'s serving mesh and (c)'s fleet groups over the four ranks of one card
SHARD_MESH = {"data": 2, "model": 2}
SHARD_FLEET = {"data": 1, "model": 2}
SHARD_WORLD = 4
SHARD_SLOTS = 4
SHARD_NEW = 16
#: 6 ragged prompts over 4 slots: the last two admit mid-flight
SHARD_LENS = (520, 610, 760, 850, 930, 990)
#: 504 latents of 512: 8 latent-growth steps, then boundary steps (K4's
#: window rows under the paged layout)
SHARD_LATENTS = 504
SHARD_LAYOUTS = ("dense", "paged")
#: replica 0 of (c) crashes on its third supervised step; (c) serves the
#: first prompts at ``SHALLOW_SERVE_LAYERS`` of the 16 layers (an earlier
#: path's depth; (b) keeps the full depth)
SHARD_CRASH_STEP = 3
SHARD_FLEET_REQUESTS = 4
SHARD_FLEET_NEW = 8
#: the drill after (b)'s paged run: requests, steps before the cancel
SHARD_DRILL = (3, 3)


def shard_workload() -> list:
    """(b)'s prompts: token ids below clm-base's vocab, from one seed."""
    import numpy as np

    rng = np.random.default_rng(73)
    return [rng.integers(1, 32000, size=n).tolist() for n in SHARD_LENS]


def shard_instrument(torch, slots_mod, collectives) -> list:
    """Time each decode op of this rank's shard (``_SlotDevice.decode``,
    a host clock between two synchronises: the step as this rank sees it,
    its collectives included) and count its collectives; returns the list
    the records go to."""
    records = []
    real = slots_mod._SlotDevice.decode

    def decode(self, *args, **kwargs):
        before = collectives.read_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(self, *args, **kwargs)
        torch.cuda.synchronize()
        after = collectives.read_counts()
        records.append({"ms": (time.perf_counter() - t0) * 1e3,
                        "comm": {k: {"calls": after[k]["calls"] - before[k]["calls"],
                                     "bytes": after[k]["bytes"] - before[k]["bytes"]}
                                 for k in collectives.KINDS if after[k]["calls"] > before[k]["calls"]}})
        return out

    slots_mod._SlotDevice.decode = decode
    return records


def shard_counts(flash, ragged, records: list, torch, dev) -> dict:
    """This rank's K1/K4 launches by route, decode-step ms and collectives a
    step since the last reset, and its peak memory."""
    plain = [r for r in records if r["comm"]]  # mesh steps (the reference's have none)
    return {"k1": dict(flash.flash_attention.route_launches),
            "k4": dict(ragged.ragged_paged_attention.route_launches),
            "decode_steps": len(records), "step_ms": [round(r["ms"], 4) for r in records],
            "step_ms_p50": _p50([r["ms"] for r in records]) if records else None,
            "collectives_per_step": plain[len(plain) // 2]["comm"] if plain else {},
            "peak_bytes": _peak(torch, dev)}


def shard_reset(flash, ragged, records: list, torch, dev) -> None:
    reset_counts(flash)
    reset_k4_counts(ragged)
    records.clear()
    _reset_peak(torch, dev)


def shard_engine(slots_mod, buckets, gen_mod, model, layout: str, dev, mesh=None):
    gcfg = gen_mod.GenerationConfig(num_latents=SHARD_LATENTS, max_new_tokens=SHARD_NEW)
    table = buckets.BucketTable(prompt_lens=SLOT_BUCKETS, batch_sizes=(1,))
    return slots_mod.SlotServingEngine(model, gcfg, table, slots=SHARD_SLOTS, kv_layout=layout, device=dev,
                                       mesh=mesh)


def shard_state_bytes(torch, state: dict, block_size: int) -> dict:
    """Each state leaf's bytes as a host array (the byte-equality pin); a
    pool leaf's null block (its first ``block_size`` rows: scratch that no
    read uses, written by scatters whose duplicate indices may race on the
    card) apart, as ``<leaf>:null``."""
    out = {}
    for k, v in state.items():
        for i, t in enumerate(v if isinstance(v, list) else [v]):
            if k in ("pool_k", "pool_v", "scale_k", "scale_v"):
                out[f"{k}/{i}:null"] = t[:block_size].contiguous().view(torch.uint8).cpu()
                t = t[block_size:]
            out[f"{k}/{i}"] = t.contiguous().view(torch.uint8).cpu()
    return out


def shard_world_one(torch, clm, flash, ragged, gen_mod, slots_mod, buckets, sharding_mod, cfg, prompts, dev):
    """(a), in the mesh phase's NCCL world of one: per layout the unsharded
    engine and the 1x1 mesh's over (b)'s traffic: tokens, the final state
    byte for byte, K1/K4 launches by route. A paged layout runs the
    unsharded engine a second time: its null blocks against the first run's
    show what the scatters' race leaves there without a mesh."""
    import numpy as np

    model = clm.CausalLanguageModel(cfg, seed=0, device=dev).eval()
    sh = sharding_mod.ServingMeshSpec(1, 1).resolve(device=dev)
    prompts = [np.asarray(p, np.int32) for p in prompts]
    out = {}
    for layout in SHARD_LAYOUTS:
        runs = {}
        again = (("plain_again", None),) if layout != "dense" else ()
        for name, mesh in (("plain", None), *again, ("mesh", sh)):
            reset_counts(flash)
            reset_k4_counts(ragged)
            engine = shard_engine(slots_mod, buckets, gen_mod, model, layout, dev, mesh)
            with torch.no_grad():
                rows = [np.asarray(r).tolist() for r in engine.serve(prompts)]
            runs[name] = dict(tokens=rows, k1=dict(flash.flash_attention.route_launches),
                              k4=dict(ragged.ragged_paged_attention.route_launches),
                              state=shard_state_bytes(torch, engine._state, engine.kv_block_size),
                              stats=engine.stats())
            del engine
        a, b = runs["plain"]["state"], runs["mesh"]["state"]
        differ = [k for k in a if k not in b or not torch.equal(a[k], b[k])]
        rerun = runs.get("plain_again", runs["plain"])["state"]
        own = [k for k in a if not torch.equal(a[k], rerun[k])]
        out[layout] = dict(
            tokens_equal=runs["plain"]["tokens"] == runs["mesh"]["tokens"], tokens=runs["plain"]["tokens"],
            leaves=len([k for k in a if not k.endswith(":null")]),
            mismatched=[k for k in differ if not k.endswith(":null")],
            null_blocks_differing=[k for k in differ if k.endswith(":null")],
            rerun_null_blocks_differing=[k for k in own if k.endswith(":null")],
            rerun_leaves_differing=[k for k in own if not k.endswith(":null")],
            launches={n: {"k1": runs[n]["k1"], "k4": runs[n]["k4"]} for n in ("plain", "mesh")},
            mesh=runs["mesh"]["stats"]["mesh"])
    del model
    _reset_peak(torch, dev)
    return out


def shard_rank_main(argv) -> int:
    """A rank of phase 14c (``python3 chip_smoke.py --shard-rank rank world
    job_dir``): joins the gloo world on the card, then (b) the 2x2 mesh and
    (c) the fleet of two 1x2 groups, rank 0 driving and the others
    following; writes ``rank<r>.json``."""
    import numpy as np
    import torch

    rank, world, job_dir = int(argv[0]), int(argv[1]), Path(argv[2])
    sys.path.insert(0, str(ROOT))
    from perceiver_io_tpu_torch import _build
    from perceiver_io_tpu_torch.inference import generate as gen_mod
    from perceiver_io_tpu_torch.models.text import clm
    from perceiver_io_tpu_torch.ops import flash_attention as flash
    from perceiver_io_tpu_torch.ops import ragged_attention as ragged
    from perceiver_io_tpu_torch.parallel import collectives, multihost
    from perceiver_io_tpu_torch.serving import buckets
    from perceiver_io_tpu_torch.serving import sharding as sharding_mod
    from perceiver_io_tpu_torch.serving import slots as slots_mod

    job = json.loads((job_dir / "job.json").read_text())
    dev = torch.device(job["device"])
    missing = [n for n in _build.sources() if not _build._target(n).exists()]
    if missing:  # a rank loads what phase 2 built
        raise RuntimeError(f"shard rank {rank}: kernels not built: {missing}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.init()
    cfg = clm.CausalLanguageModelConfig(**job["config"])
    prompts = [np.asarray(p, np.int32) for p in job["prompts"]]
    records = shard_instrument(torch, slots_mod, collectives)
    # both models (seeded alike in every rank) come up while earlier phases run
    model = clm.CausalLanguageModel(cfg, seed=0, device=dev).eval()
    shallow = clm.CausalLanguageModel(dataclasses.replace(cfg, num_self_attention_layers=SHALLOW_SERVE_LAYERS),
                                      seed=0, device=dev).eval()
    while not (job_dir / "go").exists():  # the parent's signal that the card is free
        time.sleep(0.05)
    # (a)'s single-rank tokens, written by the parent before its signal
    refs = json.loads((job_dir / "ref.json").read_text())
    multihost.initialize(f"file://{job_dir / 'store'}", world, rank, backend="gloo", device=dev)
    out = {"b": {}, "c": None}
    sh = sharding_mod.ServingMeshSpec(**SHARD_MESH).resolve(device=dev)
    for layout in SHARD_LAYOUTS:
        if rank != 0:
            shard_reset(flash, ragged, records, torch, dev)
            plans = sharding_mod.follow(sh, model)
            out["b"][layout] = dict(shard_counts(flash, ragged, records, torch, dev), plans=plans)
            continue
        try:
            out["b"][layout] = shard_drive_b(torch, flash, ragged, gen_mod, slots_mod, buckets, collectives,
                                             model, prompts, refs[layout], layout, sh, dev, records)
        finally:
            sh.stop()
    del model
    alloc = sharding_mod.MeshGroupAllocator(sharding_mod.ServingMeshSpec(**SHARD_FLEET), device=dev)
    if rank != 0:
        shard_reset(flash, ragged, records, torch, dev)
        plans = alloc.follow(shallow)
        out["c"] = dict(shard_counts(flash, ragged, records, torch, dev), plans=plans)
    else:
        try:
            out["c"] = shard_drive_c(torch, flash, ragged, gen_mod, slots_mod, buckets, shallow,
                                     prompts[:SHARD_FLEET_REQUESTS], alloc, dev, records)
        finally:
            alloc.stop()
    (job_dir / f"rank{rank}.json").write_text(json.dumps(out))
    multihost.shutdown()
    return 0


def shard_drive_b(torch, flash, ragged, gen_mod, slots_mod, buckets, collectives, model, prompts, ref, layout,
                  sh, dev, records) -> dict:
    """(b) on the driver: the traffic on the 2x2 mesh: tokens against the
    single-rank engine's (``ref``, (a)'s; the near-tie excuse on this rank's
    whole model), every data replica's pool, then a cancel and an
    evacuation (paged)."""
    import numpy as np

    failures = []
    shard_reset(flash, ragged, records, torch, dev)
    collectives.reset_counts()
    t_build = time.perf_counter()
    engine = shard_engine(slots_mod, buckets, gen_mod, model, layout, dev, sh)
    t0 = time.perf_counter()
    with torch.no_grad():
        rows = [np.asarray(r).tolist() for r in engine.serve(prompts)]
    wall = time.perf_counter() - t0
    stats = engine.stats()
    cfg = gen_mod.GenerationConfig(num_latents=SHARD_LATENTS, max_new_tokens=SHARD_NEW)
    divergences = _divergences(torch, gen_mod, model, rows, ref, prompts, [cfg] * len(prompts), failures)
    out = dict(shard_counts(flash, ragged, records, torch, dev), tokens=rows,
               divergences=divergences, failures=failures, wall_s=wall,
               tokens_per_s=stats["tokens_generated"] / wall, decode_step_ms=stats["decode_step_ms"],
               engine_build_s=t0 - t_build,
               boundary_steps=stats["boundary_steps"], mesh=stats["mesh"], plans=sh.plans,
               collectives_total=collectives.read_counts(),
               gauges={g: engine.registry.gauge(g) for g in ("serving_mesh_devices", "kv_cache_resident_bytes",
                                                             "kv_cache_resident_bytes_per_shard")})
    if engine._pool is not None:
        digests = engine.shard_digests()
        by_model = {}
        for _, m, d in digests:
            by_model.setdefault(m, set()).add(d)
        out["replicas_equal"] = all(len(v) == 1 for v in by_model.values())
        out["digests"] = digests
        n, steps = SHARD_DRILL
        reqs = [engine.submit(p) for p in prompts[:n]]
        for _ in range(steps):
            engine.step()
        resident = [e.req.request_id for e in engine._active()]
        cancelled = bool(resident) and engine.cancel(resident[0])
        evacuated = engine.evacuate(cause="scale_down")
        pool = engine._pool
        out["drill"] = dict(resident=len(resident), cancelled=cancelled, evacuated=evacuated,
                            statuses=sorted({r.status for r in reqs}), in_use=pool.in_use,
                            reserved=pool.reserved, leaked=pool.leaked())
    del engine
    return out


def shard_drive_c(torch, flash, ragged, gen_mod, slots_mod, buckets, model, prompts, alloc, dev, records) -> dict:
    """(c) on the driver: two 1x2 paged replicas through one allocator,
    replica 0 crashing on its ``SHARD_CRASH_STEP``-th step; tokens against
    this rank's single-rank engine on the same (shallow) model."""
    import numpy as np

    from perceiver_io_tpu_torch.reliability import ChaosRegistry
    from perceiver_io_tpu_torch.serving.fleet import FleetRouter

    gcfg = gen_mod.GenerationConfig(num_latents=SHARD_LATENTS, max_new_tokens=SHARD_FLEET_NEW)
    table = buckets.BucketTable(prompt_lens=SLOT_BUCKETS, batch_sizes=(1,))

    def engine(mesh=None):
        return slots_mod.SlotServingEngine(model, gcfg, table, slots=SHARD_SLOTS, kv_layout="paged", device=dev,
                                           mesh=mesh)

    def factory():
        return engine(alloc.acquire())

    with torch.no_grad():
        ref = [np.asarray(r).tolist() for r in engine().serve(prompts)]
    shard_reset(flash, ragged, records, torch, dev)
    chaos = ChaosRegistry()
    chaos.crash_replica(0, SHARD_CRASH_STEP)
    fleet = FleetRouter([factory, factory], chaos=chaos)
    before = [r.engine.sharding.ranks for r in fleet.replicas]
    t0 = time.perf_counter()
    reqs = [fleet.submit(p) for p in prompts]
    with torch.no_grad():
        fleet.run_until_idle()
    wall = time.perf_counter() - t0
    after = [r.engine.sharding.ranks for r in fleet.replicas]
    failures = []
    rows = [np.asarray(r.result).tolist() if r.result is not None else None for r in reqs]
    done = [i for i, r in enumerate(rows) if r is not None]
    divergences = _divergences(torch, gen_mod, model, [rows[i] for i in done], [ref[i] for i in done],
                               [prompts[i] for i in done], [gcfg] * len(done), failures)
    stats = fleet.stats()
    return dict(shard_counts(flash, ragged, records, torch, dev), statuses=[r.status for r in reqs],
                restarts=stats["replica_restarts"], before=before, after=after,
                disjoint=set(after[0]).isdisjoint(after[1]), divergences=divergences, failures=failures,
                wall_s=wall, leaked=[r.engine._pool.leaked() for r in fleet.replicas],
                plans=[r.engine.sharding.plans for r in fleet.replicas])


def start_shard_ranks(cfg, job_dir: Path) -> tuple:
    """Spawn (b)/(c)'s ``SHARD_WORLD`` ranks; they start (imports, CUDA
    context) and wait for :func:`finish_mesh_ranks`'s signal."""
    shutil.rmtree(job_dir, ignore_errors=True)
    job_dir.mkdir(parents=True)
    (job_dir / "job.json").write_text(json.dumps({"device": MESH_DEVICE, "config": dataclasses.asdict(cfg),
                                                  "prompts": shard_workload()}))
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    logs = [open(job_dir / f"rank{r}.log", "w") for r in range(SHARD_WORLD)]
    procs = [subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--shard-rank", str(r),
                               str(SHARD_WORLD), str(job_dir)], cwd=str(ROOT), env=env, stdout=logs[r],
                              stderr=subprocess.STDOUT)
             for r in range(SHARD_WORLD)]
    return procs, logs, job_dir, "gloo"


def shard_launches(shard: dict, kernel: str) -> dict:
    """Phase 14c's launches of ``kernel`` (``k1``, ``k4``) by route: (a)'s
    1x1 runs, and per rank (b)'s runs and (c)'s fleet."""
    out = {f"world1_{layout}": a["launches"]["mesh"][kernel] for layout, a in shard["one"].items()}
    for layout in SHARD_LAYOUTS:
        out[f"mesh2x2_{layout}"] = [r["b"][layout][kernel] for r in shard["ranks"]]
    out["fleet"] = [r["c"][kernel] for r in shard["ranks"]]
    return out


def shard_phase(torch, started: tuple, one: dict, smi: str) -> dict:
    """Phase 14c (module docstring): (a) from the mesh phase's world of one,
    (b) and (c) from the world of four started beside it."""
    failures = []
    for layout, a in one.items():
        same = a["launches"]["plain"] == a["launches"]["mesh"]
        if not (a["tokens_equal"] and not a["mismatched"] and same):
            failures.append(f"(a) {layout}: tokens equal {a['tokens_equal']}, leaves differing "
                            f"{a['mismatched'][:6]}, launches {a['launches']}")
        k4 = a["launches"]["mesh"]["k4"]
        if layout == "paged" and (k4["simt"] or not (k4["split"] and k4["tc"])):
            failures.append(f"(a) paged: K4 launches {k4}")
        emit("shard", case="world1", layout=layout, backend="nccl", device=MESH_DEVICE, mesh=a["mesh"],
             tokens_equal=a["tokens_equal"], state_leaves=a["leaves"], leaves_differing=a["mismatched"],
             null_blocks_differing=a["null_blocks_differing"],
             unsharded_rerun=dict(null_blocks_differing=a["rerun_null_blocks_differing"],
                                  leaves_differing=a["rerun_leaves_differing"]),
             launches=a["launches"], nvidia_smi=smi)
    (started[2] / "ref.json").write_text(json.dumps({layout: a["tokens"] for layout, a in one.items()}))
    ranks = finish_mesh_ranks(started)
    r0 = ranks[0]
    for layout in SHARD_LAYOUTS:
        b = r0["b"][layout]
        failures += [f"(b) {layout}: {f}" for f in b["failures"]]
        if layout == "paged":
            d = b["drill"]
            if not b["replicas_equal"]:
                failures.append(f"(b) paged: data replicas differ {b['digests']}")
            if not (d["cancelled"] and d["in_use"] == 0 and d["leaked"] == 0 and d["reserved"] == 0):
                failures.append(f"(b) paged drill: {d}")
        for rank, res in enumerate(ranks):
            rb = res["b"][layout]
            k1, k4 = rb["k1"], rb["k4"]
            if not (k1["split"] and k1["tf32x3"]) or any(n for r, n in k1.items() if r not in ("split", "tf32x3")):
                failures.append(f"(b) {layout} rank {rank}: K1 launches {k1}")
            if layout == "paged" and (k4["simt"] or not (k4["split"] and k4["tc"])):
                failures.append(f"(b) paged rank {rank}: K4 launches {k4}")
            if layout == "dense" and any(k4.values()):
                failures.append(f"(b) dense rank {rank}: K4 launches {k4}")
            if not rb["decode_steps"]:
                failures.append(f"(b) {layout} rank {rank}: no decode step ran")
            if not b["boundary_steps"]:
                failures.append(f"(b) {layout}: no boundary step ran")
            emit("shard", case="mesh2x2", layout=layout, rank=rank, backend="gloo", device=MESH_DEVICE,
                 mesh=SHARD_MESH, k1_route_launches=k1, k4_route_launches=k4, decode_steps=rb["decode_steps"],
                 step_ms_p50=rb["step_ms_p50"], collectives_per_step=rb["collectives_per_step"],
                 peak_bytes=rb["peak_bytes"], plans=rb["plans"], nvidia_smi=smi,
                 **({} if rank else {k: b[k] for k in ("divergences", "tokens_per_s", "decode_step_ms",
                                                        "boundary_steps", "wall_s", "gauges", "engine_build_s")}),
                 **({"replicas_equal": b["replicas_equal"], "drill": b["drill"]}
                    if rank == 0 and layout == "paged" else {}))
    c = r0["c"]
    failures += [f"(c): {f}" for f in c["failures"]]
    if not (c["statuses"] == ["ok"] * SHARD_FLEET_REQUESTS and c["restarts"] == 1 and c["before"] == c["after"]
            and c["disjoint"] and not any(c["leaked"])):
        failures.append(f"(c): statuses {c['statuses']}, restarts {c['restarts']}, groups {c['before']} -> "
                        f"{c['after']}, leaked {c['leaked']}")
    for rank, res in enumerate(ranks):
        rc = res["c"]
        if not (rc["k1"]["split"] and rc["k4"]["split"]) or rc["k4"]["simt"]:
            failures.append(f"(c) rank {rank}: K1 {rc['k1']}, K4 {rc['k4']}")
        emit("shard", case="fleet", rank=rank, backend="gloo", device=MESH_DEVICE, mesh=SHARD_FLEET,
             k1_route_launches=rc["k1"], k4_route_launches=rc["k4"], decode_steps=rc["decode_steps"],
             step_ms_p50=rc["step_ms_p50"], collectives_per_step=rc["collectives_per_step"],
             peak_bytes=rc["peak_bytes"], plans=rc["plans"], nvidia_smi=smi,
             **({} if rank else {k: c[k] for k in ("statuses", "restarts", "before", "after", "disjoint",
                                                    "divergences", "wall_s")}))
    if failures:
        raise AssertionError("shard phase: " + "; ".join(failures[:12]))
    return {"ranks": ranks, "one": one}


def giantmidi_config(sam):
    # docs/pretrained-models.md "GiantMIDI symbolic audio, 134M" (examples/convert.py
    # sam ... --max-seq-len 6144 --max-latents 2048 --num-channels 768 --num-layers 12)
    return sam.SymbolicAudioModelConfig(max_seq_len=6144, max_latents=2048, num_channels=768,
                                        num_self_attention_layers=12)


def sam_workload(torch, gen_mod, midi):
    """(b)'s 8 event-id requests in two configs: 4 prompts of 384-2880
    tokens with 64 latents (latent growth) and 4 of 3120-5400 with 2032
    (16 latent-growth, 8 boundary and 8 sliding-window steps in the 6120
    bucket), 32 new tokens each."""
    rng = torch.Generator().manual_seed(17)
    groups = [(64, [384, 1200, 1998, 2880]), (SAM_LATENTS, [3120, 4200, 4800, 5400])]
    return [(gen_mod.GenerationConfig(max_new_tokens=32, num_latents=m, pad_token_id=midi.PAD_TOKEN),
             [torch.randint(0, midi.PAD_TOKEN, (n,), generator=rng).numpy() for n in lens])
            for m, lens in groups]


def sam_slot_workload(torch, gen_mod, midi):
    """(c)'s 8 requests: ``(config, prompts, max_new)``, prompts of
    3000-5760 event ids with 2032 latents, ``max_new_tokens`` 16/32."""
    rng = torch.Generator().manual_seed(23)
    lens = [3000, 3400, 3900, 4300, 4700, 5100, 5500, 5760]
    prompts = [torch.randint(0, midi.PAD_TOKEN, (n,), generator=rng).numpy() for n in lens]
    return (gen_mod.GenerationConfig(num_latents=SAM_LATENTS, pad_token_id=midi.PAD_TOKEN), prompts,
            [(16, 32)[i % 2] for i in range(len(lens))])


def sam_train_batches(data_audio, cfg, n: int = 2):
    """``n`` batches of 8 rows from ``SyntheticSymbolicAudioDataModule`` at
    ``min_seq_len`` 4096 (sam.sh), the module's train loader, and 4 rows of
    its validation split (full windows) as one batch."""
    dm = data_audio.SyntheticSymbolicAudioDataModule(
        cfg.max_seq_len, min_seq_len=4096, batch_size=8, num_train_pieces=8, num_valid_pieces=4,
        num_test_pieces=0, mean_piece_len=16384, seed=0, shard_index=0, shard_count=1)
    dm.setup()
    loader = dm.train_dataloader()
    val = {k: v[:4] for k, v in next(iter(dm.val_dataloader())).items()}
    return list(itertools.islice(iter(loader), n)), loader, [val]


def symbolic_forward(torch, sam, flash, cfg) -> dict:
    """(a) one forward at b = 2 over the full context, fp32 and bf16: the
    kernels against ``attention_impl="xla"`` at the model phase's gates,
    every K1 launch on the route the type picks."""
    g = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randint(0, 388, (2, cfg.max_seq_len), generator=g, device="cuda")
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        model = sam.SymbolicAudioModel(cfg, dtype=dtype, seed=0).eval()
        reset_counts(flash)
        with torch.no_grad():
            logits = model(x, prefix_len=cfg.max_prefix_len)
            routes = dict(flash.flash_attention.route_launches)
            set_attention_impl(model, "xla")
            plain = model(x, prefix_len=cfg.max_prefix_len)
        diff = (logits.float() - plain.float()).abs()
        err = diff.max().item()
        tol = 1e-3 if dtype == torch.float32 else 8 * bf16_ulp(plain.float().abs().max().item())
        finite = bool(torch.isfinite(logits).all().item())
        shape_ok = tuple(logits.shape) == (2, cfg.max_latents, cfg.vocab_size)
        tname = str(dtype).split(".")[-1]
        line = dict(part="forward", dtype=tname, params=sum(p.numel() for p in model.parameters()),
                    logits_shape=list(logits.shape), max_abs_err_vs_plain=err, tol=tol,
                    logits_max_abs=plain.float().abs().max().item(), finite=finite,
                    k1_route_launches=routes)
        emit("symbolic", **line)
        expected = "wgmma" if dtype == torch.bfloat16 else "tf32x3"
        if not (err <= tol and finite and shape_ok) or not 0 < routes[expected] == sum(routes.values()):
            raise AssertionError(f"symbolic forward {tname}: max|d| {err} (tol {tol}), finite {finite}, "
                                 f"shape {tuple(logits.shape)}, K1 routes {routes}")
        out[tname] = line
        del model, logits, plain, diff
        torch.cuda.empty_cache()
    return out


def symbolic_pipeline(torch, flash, pipelines_mod, midi, model, work, refs) -> dict:
    """(d) the ``symbolic-audio-generation`` pipeline: greedy over (b)'s
    prompts equals ``generate()``; sampled (temperature 1.0, top-k 15, a
    ``torch.Generator``) gives event ids below the pad id that
    ``notes_from_events`` decodes, the same for the same seed; beam search
    with 2 beams over one prompt."""
    pipe = pipelines_mod.pipeline("symbolic-audio-generation", model)
    failures = []
    greedy_equal = True
    reset_counts(flash)
    for (cfg, prompts), group_refs in zip(work, refs):
        rows = pipe(list(prompts), max_new_tokens=cfg.max_new_tokens, num_latents=cfg.num_latents)
        for p, row, ref in zip(prompts, rows, group_refs):
            greedy_equal &= bool((row[len(p):] == ref).all()) and bool((row[:len(p)] == p).all())
    greedy_launches = dict(flash.flash_attention.route_launches)
    if not greedy_equal:
        failures.append("greedy pipeline rows differ from generate()")
    cfg, prompts = work[0]
    sample_kw = dict(max_new_tokens=cfg.max_new_tokens, num_latents=cfg.num_latents, **SAM_SAMPLE)
    a, again, b = (pipe(list(prompts), seed=s, **sample_kw) for s in (1, 1, 2))
    new = [row[len(p):] for p, row in zip(prompts, a)]
    in_range = all(((n >= 0) & (n < midi.PAD_TOKEN)).all() for n in new)
    pads = int(sum((n == midi.PAD_TOKEN).sum() for n in new))
    notes = [len(midi.notes_from_events(row)) for row in a]
    same_seed = all((x == y).all() for x, y in zip(a, again))
    other_seed = any((x != y).any() for x, y in zip(a, b))
    if not (in_range and same_seed and other_seed):
        failures.append(f"sampled: ids in [0, {midi.PAD_TOKEN}) {in_range} (pad ids {pads}), seed repeats "
                        f"{same_seed}, another seed differs {other_seed}")
    reset_counts(flash)
    t0 = time.perf_counter()
    beam = pipe([prompts[0]], max_new_tokens=8, num_latents=cfg.num_latents, num_beams=2)[0]
    beam_s = time.perf_counter() - t0
    beam_launches = dict(flash.flash_attention.route_launches)
    if len(beam) != len(prompts[0]) + 8 or not ((beam >= 0) & (beam < midi.VOCAB_SIZE)).all():
        failures.append(f"beam row of {len(beam)} ids")
    emit("symbolic", part="pipeline", greedy_equal_generate=greedy_equal, greedy_k1_route_launches=greedy_launches,
         sampled=SAM_SAMPLE, sampled_new_tokens=int(sum(len(n) for n in new)), sampled_below_pad_id=in_range,
         sampled_pad_ids=pads, sampled_notes_decoded=notes, sampled_same_seed_equal=same_seed,
         sampled_other_seed_differs=other_seed, beam_num_beams=2, beam_new_tokens=beam[len(prompts[0]):].tolist(),
         beam_s=beam_s, beam_k1_route_launches=beam_launches)
    if failures:
        raise AssertionError("symbolic pipeline: " + "; ".join(failures))
    return {"greedy_k1_routes": greedy_launches, "beam_k1_routes": beam_launches}


def symbolic_phase(torch, sam, flash, ragged, gen_mod, engine_mod, slots_mod, buckets, pipelines_mod,
                   training, parallel, data_audio, root: Path) -> dict:
    """Phase 15: the symbolic-audio family at GiantMIDI width, random
    weights from a seed: (a) forward, (b) bucket serve (phase 5's
    ``serve_phase``), (c) slot serve (phase 7's ``slot_serve_phase``), (d)
    the pipeline, (e) training (phase 13's ``train_fit``). Returns each
    run's launches."""
    import dataclasses

    from perceiver_io_tpu_torch.data.audio import midi

    full = giantmidi_config(sam)
    t0 = time.perf_counter()
    out = {"forward": symbolic_forward(torch, sam, flash, full)}
    # (b)-(e) at GiantMIDI's widths over SYMBOLIC_LAYERS of its 12 layers (a
    # cut of depth; every gate of theirs follows the depth)
    cfg = dataclasses.replace(full, num_self_attention_layers=SYMBOLIC_LAYERS)
    model = sam.SymbolicAudioModel(cfg, dtype=torch.float32, seed=0).eval()
    emit("symbolic", part="model", params=sum(p.numel() for p in model.parameters()),
         config=dataclasses.asdict(cfg))
    work = sam_workload(torch, gen_mod, midi)
    out["bucket_serve"] = serve_phase(torch, flash, gen_mod, engine_mod, model,
                                      buckets.BucketTable(prompt_lens=SAM_BUCKETS, batch_sizes=(4,)), work,
                                      phase="symbolic_serve")
    out["slot_serve"], _ = slot_serve_phase(
        torch, flash, ragged, gen_mod, slots_mod, model,
        buckets.BucketTable(prompt_lens=SAM_SLOT_BUCKETS, batch_sizes=(1,)),
        sam_slot_workload(torch, gen_mod, midi), phase="symbolic_slot_serve")
    no_boundary = [layout for layout, run in out["slot_serve"].items() if run["boundary_steps"] == 0]
    if no_boundary:
        raise AssertionError(f"symbolic slot serve: no boundary step under {no_boundary}")
    out["pipeline"] = symbolic_pipeline(torch, flash, pipelines_mod, midi, model, work,
                                        out["bucket_serve"]["refs"])
    del model
    torch.cuda.empty_cache()
    batches, loader, val = sam_train_batches(data_audio, cfg)
    out["train"] = {}
    for dtype in (torch.bfloat16, torch.float32):
        tname = str(dtype).split(".")[-1]
        shutil.rmtree(root / tname, ignore_errors=True)
        out["train"][tname] = train_fit(torch, flash, training, parallel, sam.SymbolicAudioModel, cfg, dtype,
                                        root / tname, loader, batches, val, lr=SAM_LR,
                                        warmup_steps=SAM_WARMUP, phase="symbolic_train")
    emit("symbolic", part="done", seconds=time.perf_counter() - t0)
    return out


# the obs phase: three of phase 7's requests (500, 530 and 600 tokens; 16, 32
# and 48 new) through the paged slot engine under recompute preemption. Their
# worst cases take 110 blocks of 16: at 108 this schedule runs without a
# preemption or a wait, while a kv.exhaust preemption's victim readmits under
# its worst case and must wait (one pool_exhausted incident)
OBS_REQUESTS = (0, 1, 2)
OBS_KV_BLOCKS = 108
OBS_EXHAUST_STEP = 2
# the observed run arms the profiler trigger before this step and reads the
# memory gauges two steps later, residents in flight
OBS_ARM_STEP = 8


def csrc_kernels(prefix: str) -> set:
    """The ``__global__`` function names of ``csrc/<prefix>*.cu``."""
    names = set()
    for path in sorted((ROOT / "perceiver_io_tpu_torch" / "csrc").glob(f"{prefix}*.cu")):
        names |= set(re.findall(r"__global__ void __launch_bounds__\([^)]*\)\s+(\w+)\(", path.read_text()))
    return names


def obs_phase(torch, flash, ragged, gen_mod, slots_mod, buckets, serve, root: Path, smi: str) -> dict:
    """Phase 11b: the slot engine with every telemetry attachment (a
    registry, a tracer streaming ``events.jsonl``, a step timeline, a
    flight recorder, an SLO monitor and a profiler trigger) over three of
    phase 7's requests, ``OBS_KV_BLOCKS`` pool blocks, ``recompute``
    preemption, K1 and K4 on the card. Returns the observed run's launches."""
    import contextlib
    import io

    from perceiver_io_tpu_torch import _build
    from perceiver_io_tpu_torch.observability import (
        FlightRecorder,
        JsonlSpanSink,
        MetricsRegistry,
        ProfilerTrigger,
        SLOMonitor,
        SLOPolicy,
        StepTimeline,
        Tracer,
        default_ledger,
        default_registry,
    )
    from perceiver_io_tpu_torch.reliability import ChaosRegistry
    from perceiver_io_tpu_torch.scripts.text import clm as clm_script

    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    model, gcfg = serve["model"], serve["gcfg"]
    prompts = [serve["prompts"][i] for i in OBS_REQUESTS]
    configs = [serve["configs"][i] for i in OBS_REQUESTS]
    refs = [serve["refs"][i] for i in OBS_REQUESTS]
    table = buckets.BucketTable(prompt_lens=SLOT_BUCKETS, batch_sizes=(1,))

    def make_kit(name):
        d = root / name
        d.mkdir()
        reg = MetricsRegistry()
        sink = JsonlSpanSink(str(d / "events.jsonl"))
        tracer = Tracer(sink=sink)
        rec = FlightRecorder(str(d / "incidents"), tracer=tracer, registry=reg)
        return dict(dir=d, registry=reg, sink=sink, tracer=tracer, recorder=rec,
                    timeline=StepTimeline(cap=4096, registry=reg),
                    slo=SLOMonitor(SLOPolicy(ttft_p95_ms=60000.0), registry=reg, tracer=tracer,
                                   flight_recorder=rec),
                    trigger=ProfilerTrigger(str(d / "profile")))

    def engine(kit=None, chaos=None):
        obs = {} if kit is None else dict(registry=kit["registry"], tracer=kit["tracer"],
                                          profiler_trigger=kit["trigger"])
        eng = slots_mod.SlotServingEngine(model, gcfg, table, slots=4, kv_layout="paged",
                                          kv_blocks=OBS_KV_BLOCKS, preemption="recompute",
                                          admit_headroom_blocks=0, chaos=chaos, **obs)
        if kit is not None:
            eng.timeline, eng.flight_recorder = kit["timeline"], kit["recorder"]
            eng.latency_sink = kit["slo"].sink
            kit["slo"].watch_counters(kit["registry"].counters, prefix="serving")
            kit["recorder"].add_source("health", eng.health)
            kit["recorder"].add_source("kv_pool", eng._pool.stats)
        return eng

    def drive(eng, kit=None, on_step=None):
        reset_counts(flash)  # count this run's launches only
        reset_k4_counts(ragged)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reqs = [eng.submit(p, c) for p, c in zip(prompts, configs)]
        step = 0
        while eng.pending():
            if on_step is not None:
                on_step(eng, step)
            eng.step()
            step += 1
            if kit is not None:
                kit["slo"].poll()
                kit["recorder"].maybe_record()
        torch.cuda.synchronize()
        if kit is not None:
            kit["sink"].close()
        return dict(rows=[r.result for r in reqs], status=[r.status for r in reqs], steps=step,
                    wall_s=time.perf_counter() - t0,
                    decode_step_ms_p50=eng.registry.percentile("serving_decode_step_ms", 50.0),
                    k1=flash.flash_attention.launches, k1_routes=dict(flash.flash_attention.route_launches),
                    k4=ragged.ragged_paged_attention.launches,
                    k4_routes=dict(ragged.ragged_paged_attention.route_launches),
                    preemptions=eng.stats()["preemption"]["preemptions"], pool=(eng._pool.in_use, eng._pool.leaked()))

    readings = {}

    def observe(eng, step):
        """Arm the trigger before ``OBS_ARM_STEP``; two steps later read the
        device and KV gauges beside what they count."""
        if step == OBS_ARM_STEP:
            readings["armed"] = eng.profiler_trigger.arm()
        if step == OBS_ARM_STEP + 2:
            hbm = default_ledger().update_device_gauges()
            allocated = torch.cuda.memory_allocated()
            st = eng._state
            position = sum(st[k][0].numel() * st[k].element_size()
                           for k in ("pool_k", "pool_v", "scale_k", "scale_v") if k in st)
            stack = sum(t.numel() * t.element_size() for t in st["stack_k"] + st["stack_v"])
            readings.update(hbm_bytes_in_use=hbm, memory_allocated=allocated,
                            hbm_gauge=default_registry().gauge("hbm_bytes_in_use"),
                            kv_cache_resident_bytes=eng.registry.gauge("kv_cache_resident_bytes"),
                            pool_tensor_bytes=eng._pool.in_use * eng.kv_block_size * position + stack,
                            pool_in_use=eng._pool.in_use, residents=len(eng._active()))

    failures = []
    plain = drive(engine())
    kit = make_kit("observed")
    observed = drive(engine(kit), kit, observe)

    # (a) telemetry changes no token and no launch; the tokens are phase 7's
    if any((a != b).any() for a, b in zip(observed["rows"], plain["rows"])):
        failures.append("the observed run's tokens differ from the unobserved run's")
    divergences = _divergences(torch, gen_mod, model, observed["rows"], refs, prompts, configs, failures)
    for key in ("k1", "k1_routes", "k4", "k4_routes"):
        if observed[key] != plain[key]:
            failures.append(f"{key}: observed {observed[key]}, unobserved {plain[key]}")
    if observed["status"] != ["ok"] * len(prompts) or observed["pool"] != (0, 0) or observed["preemptions"]:
        failures.append(f"observed run: {observed['status']}, pool {observed['pool']}, "
                        f"preemptions {observed['preemptions']}")
    if kit["recorder"].bundles:
        failures.append(f"the run without a fault bundled {kit['recorder'].bundles}")
    spans = kit["tracer"].spans()
    terminal = [s for s in spans if s.name == "serving.request"]
    if sorted(s.status for s in terminal) != ["ok"] * len(prompts):
        failures.append(f"terminal spans {[(s.trace_id, s.status) for s in terminal]}")

    # (b) the armed trigger ran one decode step under torch.profiler; its
    # Chrome trace names K1's and K4's kernels
    traces = sorted((kit["dir"] / "profile").glob("regress-step*/trace.json"))
    trace_kernels = set()
    if len(traces) != 1 or kit["trigger"].captures != 1:
        failures.append(f"captures {kit['trigger'].captures}, traces {traces}: one armed step, one trace")
    else:
        events = json.loads(traces[0].read_text()).get("traceEvents", [])
        trace_kernels = {e.get("name", "") for e in events if e.get("cat") == "kernel"}
    k1_names, k4_names = csrc_kernels("flash_attention_fwd"), csrc_kernels("ragged_paged_attention")
    k1_seen = sorted(n for n in k1_names if any(n in k for k in trace_kernels))
    k4_seen = sorted(n for n in k4_names if any(n in k for k in trace_kernels))
    if traces and (not k1_seen or not k4_seen):
        failures.append(f"the trace names K1 {k1_seen}, K4 {k4_seen} of {len(trace_kernels)} kernels")

    # (c) the device and KV gauges against what they count
    if not (readings.get("hbm_bytes_in_use") == readings.get("memory_allocated") == readings.get("hbm_gauge")):
        failures.append(f"hbm_bytes_in_use {readings}")
    if readings.get("kv_cache_resident_bytes") != readings.get("pool_tensor_bytes") \
            or not readings.get("residents"):
        failures.append(f"kv_cache_resident_bytes {readings}")

    # (d) a kv.exhaust fault: one preemption more, the victim's readmission
    # waits, one pool_exhausted bundle, which obs incident renders
    chaos = ChaosRegistry()
    chaos.exhaust_kv(OBS_EXHAUST_STEP)
    ekit = make_kit("kv_exhaust")
    exhausted = drive(engine(ekit, chaos), ekit)
    bundles = ekit["recorder"].bundles
    incident = obs_cli(clm_script, ["obs", "incident", f"--bundle={bundles[0]}"]) if len(bundles) == 1 else ""
    _divergences(torch, gen_mod, model, exhausted["rows"], refs, prompts, configs, failures)
    if len(bundles) != 1 or not bundles[0].endswith("pool_exhausted") or "pool_exhausted" not in incident \
            or chaos.fired_count("kv.exhaust") != 1 or exhausted["preemptions"] < 1:
        failures.append(f"kv.exhaust: bundles {bundles}, fired {chaos.fired_count('kv.exhaust')}, "
                        f"preemptions {exhausted['preemptions']}, incident text {incident[:200]!r}")
    if exhausted["status"] != ["ok"] * len(prompts) or exhausted["pool"] != (0, 0):
        failures.append(f"kv.exhaust run: {exhausted['status']}, pool {exhausted['pool']}")

    # (e) one kernel_build record per source this process built
    builds = default_ledger().records(site="kernel_build")
    built = sorted(f"csrc/{name}.cu" for name in _build.BUILD_LOG)
    if sorted(r["components"]["source"] for r in builds) != built:
        failures.append(f"kernel_build records {[r['components']['source'] for r in builds]}, built {built}")

    # (f) the telemetry's host cost: decode-step p50 with and without, A B B A
    observed_again = drive(engine(make_kit("observed_again")))
    plain_again = drive(engine())
    p50 = {"unobserved": [plain["decode_step_ms_p50"], plain_again["decode_step_ms_p50"]],
           "observed": [observed["decode_step_ms_p50"], observed_again["decode_step_ms_p50"]]}
    overhead = _mean(p50["observed"]) - _mean(p50["unobserved"])
    emit("obs", card=smi, requests=len(prompts), kv_blocks=OBS_KV_BLOCKS, steps=observed["steps"],
         divergences_vs_generate=divergences, k1_launches=observed["k1"],
         k1_route_launches=observed["k1_routes"], k4_launches=observed["k4"],
         k4_route_launches=observed["k4_routes"], unobserved_launches=[plain["k1"], plain["k4"]],
         spans=len(spans), span_names=sorted({s.name for s in spans}), timeline_records=len(kit["timeline"]),
         counters={k: v for k, v in kit["registry"].counters().items() if v},
         trace=str(traces[0].relative_to(ROOT)) if traces else None,
         trace_bytes=traces[0].stat().st_size if traces else None, trace_kernel_names=sorted(trace_kernels),
         k1_kernels_in_trace=k1_seen, k4_kernels_in_trace=k4_seen, gauges=readings,
         kv_exhaust=dict(bundles=[Path(b).name for b in bundles], preemptions=exhausted["preemptions"],
                         steps=exhausted["steps"], incident_lines=len(incident.splitlines())),
         kernel_builds=len(builds), kernel_build_ms_total=round(sum(r["compile_ms"] for r in builds), 3),
         kernel_build_ms_max=max((r["compile_ms"] for r in builds), default=None),
         decode_step_ms_p50=p50, telemetry_overhead_ms_per_step=overhead,
         walls_s={"unobserved": [plain["wall_s"], plain_again["wall_s"]],
                  "observed": [observed["wall_s"], observed_again["wall_s"]]})
    if failures:
        raise AssertionError("obs: " + "; ".join(failures))
    return {k: observed[k] for k in ("k1", "k1_routes", "k4", "k4_routes")}


# the fleet phase: 8 of phase 7's 12 requests (prompts 500-960, 496 latents,
# 16/32/48 new tokens) through a fleet of two paged slot replicas of 4 slots
FLEET_REQUESTS = (0, 2, 4, 6, 8, 9, 10, 11)
FLEET_SLOTS = 4
#: replica 0's supervised step that crashes in (b): its 4 residents are
#: admitted by its 4th step and decode 16-48 tokens, so the 12th is mid-decode
FLEET_CRASH_STEP = 12
#: fleet steps before (c) retires replica 0, and before (d) evacuates one
FLEET_REMOVE_AFTER = 12
FLEET_RESIZE = (6, 4)
#: (e): concurrent SSE streams, then one more cut before its third token
FLEET_STREAMS = 4
FLEET_CUT_AFTER = 3
#: (b) and (c): memory_allocated() after gc within this share of its value
#: before the crash or the removal
FLEET_MEMORY_TOL = 0.01
FLEET_GATEWAY_TIMEOUT_S = 120.0


def fleet_phase(torch, flash, ragged, gen_mod, slots_mod, buckets, serve, smi: str) -> dict:
    """Phase 11c: outer serving. ``FLEET_REQUESTS`` of phase 7's requests
    through ``FleetRouter`` over two paged ``SlotServingEngine`` replicas of
    ``FLEET_SLOTS`` slots (fp32, clm-base): (a) no fault, beside one engine
    of twice the slots; (b) ``crash_replica(0, FLEET_CRASH_STEP)``; (c)
    ``remove_replica`` mid-flight, then ``add_replica`` and a ``restart``;
    (d) ``resize_slots`` 4 -> 6 -> 4 on a replica evacuated mid-flight,
    which then serves the requests it lost; (e) ``StreamingGateway`` over a
    fleet on ``127.0.0.1:0``, streams through ``GatewayHttpClient``, one cut
    by ``disconnect_stream``. Tokens are held to phase 7's ``generate()``
    references in (a) and to (a)'s rows after, a divergence excused only at a
    near tie (``_divergences``); K1 on split/tf32x3 and K4 on split/tc in
    every run. Returns each run's launches."""
    import gc
    import http.client
    import itertools

    import numpy as np

    from perceiver_io_tpu_torch.observability import GatewayHttpClient, MetricsRegistry, Tracer
    from perceiver_io_tpu_torch.reliability import ChaosRegistry
    from perceiver_io_tpu_torch.serving.fleet import FleetRouter
    from perceiver_io_tpu_torch.serving.gateway import GATEWAY_COUNTERS, StreamingGateway

    model, gcfg = serve["model"], serve["gcfg"]
    prompts = [serve["prompts"][i] for i in FLEET_REQUESTS]
    configs = [serve["configs"][i] for i in FLEET_REQUESTS]
    refs = [serve["refs"][i] for i in FLEET_REQUESTS]
    tokens = sum(c.max_new_tokens for c in configs)
    table = buckets.BucketTable(prompt_lens=SLOT_BUCKETS, batch_sizes=(1,))
    failures, launches = [], {}

    def factory(slots: int = FLEET_SLOTS):
        return slots_mod.SlotServingEngine(model, gcfg, table, slots=slots, kv_layout="paged")

    def memory() -> int:
        gc.collect()
        torch.cuda.synchronize()
        return torch.cuda.memory_allocated()

    def start() -> float:
        reset_counts(flash)
        reset_k4_counts(ragged)
        torch.cuda.synchronize()
        return time.perf_counter()

    def stop(run: str, t0: float) -> float:
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k1r = dict(flash.flash_attention.route_launches)
        k4r = dict(ragged.ragged_paged_attention.route_launches)
        c = launches[run] = dict(k1=flash.flash_attention.launches, k1_routes=k1r,
                                 k4=ragged.ragged_paged_attention.launches, k4_routes=k4r)
        if not (k1r["split"] > 0 and k1r["tf32x3"] > 0 and k1r["split"] + k1r["tf32x3"] == c["k1"]):
            failures.append(f"{run}: K1 routes {k1r}, fp32 serving takes split and tf32x3 only")
        if not (k4r["split"] > 0 and k4r["tc"] > 0 and k4r["split"] + k4r["tc"] == c["k4"]):
            failures.append(f"{run}: K4 routes {k4r}, decode rows take split, window rows tc, never simt")
        return wall

    def leak_free(run: str, engines) -> list:
        out = []
        for eng in engines:
            st = eng._pool.stats()
            out.append({k: st[k] for k in ("in_use", "reserved", "leaked", "frees_by_cause")})
            if st["in_use"] or st["reserved"] or st["leaked"]:
                failures.append(f"{run}: pool in_use {st['in_use']}, reserved {st['reserved']}, "
                                f"leaked {st['leaked']}")
        return out

    def held(run: str, reqs, base, idx=None) -> list:
        """Each request ok, its row held to ``base`` (near ties excused)."""
        idx = list(range(len(reqs))) if idx is None else idx
        if [r.status for r in reqs] != ["ok"] * len(reqs):
            failures.append(f"{run}: statuses {[r.status for r in reqs]}")
            return []
        return _divergences(torch, gen_mod, model, [np.asarray(r.result) for r in reqs], [base[i] for i in idx],
                            [prompts[i] for i in idx], [configs[i] for i in idx], failures)

    def check_memory(run: str, before: int, after: int) -> None:
        if abs(after - before) > FLEET_MEMORY_TOL * before:
            failures.append(f"{run}: memory_allocated {after} after against {before} before")

    # (a) no fault, and one engine with the fleet's 8 slots in total
    fleet = FleetRouter([factory] * 2, tracer=Tracer())
    t0 = start()
    reqs = [fleet.submit(p, c) for p, c in zip(prompts, configs)]
    fleet.run_until_idle()
    wall_a = stop("no_fault", t0)
    rows_a = [np.asarray(r.result) for r in reqs]
    div_a = held("no_fault", reqs, refs)
    stats_a = fleet.stats()
    pools_a = leak_free("no_fault", [r.engine for r in fleet.replicas])
    del fleet, reqs
    one = factory(2 * FLEET_SLOTS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one_reqs = [one.submit(p, c) for p, c in zip(prompts, configs)]
    one.run_until_idle()
    torch.cuda.synchronize()
    wall_one = time.perf_counter() - t0
    div_one = held("one_engine", one_reqs, refs)
    del one, one_reqs
    emit("fleet", part="no_fault", card=smi, replicas=2, slots=FLEET_SLOTS, requests=len(prompts), tokens=tokens,
         wall_s=wall_a, tokens_per_s=tokens / wall_a, one_engine_slots=2 * FLEET_SLOTS, one_engine_wall_s=wall_one,
         one_engine_tokens_per_s=tokens / wall_one, fleet_over_one_engine=wall_one / wall_a,
         ttft_ms_p50=stats_a["ttft_ms"]["p50"], completed_by_replica=stats_a["completed_by_replica"],
         divergences_vs_generate=div_a, one_engine_divergences=div_one, pools=pools_a, **launches["no_fault"])

    # (b) replica 0 crashes mid-decode: its work replays on replica 1
    chaos = ChaosRegistry()
    chaos.crash_replica(0, FLEET_CRASH_STEP)
    fleet = FleetRouter([factory] * 2, chaos=chaos, tracer=Tracer())
    t0 = start()
    reqs = [fleet.submit(p, c) for p, c in zip(prompts, configs)]
    mem_before = None
    for step in itertools.count(1):
        if step == FLEET_CRASH_STEP:
            mem_before = memory()
        fleet.step()
        if step == FLEET_CRASH_STEP and chaos.fired_count("fleet.replica_step.0") != 1:
            failures.append(f"crash: the fault had not fired by fleet step {step}")
        if not fleet.pending():
            break
    wall_b = stop("crash", t0)
    div_b = held("crash", reqs, rows_a)
    stats_b = fleet.stats()
    pools_b = leak_free("crash", [r.engine for r in fleet.replicas])
    del reqs
    mem_after = memory()
    check_memory("crash", mem_before, mem_after)
    if stats_b["fleet_failover_total"] < 1 or stats_b["replica_restarts"] != 1:
        failures.append(f"crash: failovers {stats_b['fleet_failover_total']}, "
                        f"restarts {stats_b['replica_restarts']}")
    emit("fleet", part="crash", card=smi, crash_step=FLEET_CRASH_STEP, wall_s=wall_b,
         replay_cost_ms=(wall_b - wall_a) * 1e3, failovers=stats_b["fleet_failover_total"],
         redispatches=stats_b["redispatches"], replica_restarts=stats_b["replica_restarts"],
         completed_by_replica=stats_b["completed_by_replica"], divergences_vs_no_fault=div_b,
         memory_before=mem_before, memory_after=mem_after, pools=pools_b, **launches["crash"])
    del fleet

    # (c) replica 0 retires mid-flight; a replica is added back and restarted
    fleet = FleetRouter([factory] * 2, tracer=Tracer())
    t0 = start()
    reqs = [fleet.submit(p, c) for p, c in zip(prompts, configs)]
    for _ in range(FLEET_REMOVE_AFTER):
        fleet.step()
    in_flight = len(fleet.replicas[0].handles)
    mem_before = memory()
    t_remove = time.perf_counter()
    removed = fleet.remove_replica(fleet.replicas[0].replica_id)
    torch.cuda.synchronize()
    remove_ms = (time.perf_counter() - t_remove) * 1e3
    pool_removed = leak_free("remove", [removed.engine])[0]
    if not pool_removed["frees_by_cause"].get("scale_down") or in_flight == 0:
        failures.append(f"remove: {in_flight} in flight, frees {pool_removed['frees_by_cause']}")
    del removed
    fleet.run_until_idle()
    wall_c = stop("remove", t0)
    div_c = held("remove", reqs, rows_a)
    stats_c = fleet.stats()
    del reqs
    mem_removed = memory()
    t_add = time.perf_counter()
    fleet.add_replica()
    torch.cuda.synchronize()
    add_ms = (time.perf_counter() - t_add) * 1e3
    mem_added = memory()
    check_memory("remove", mem_before, mem_added)
    if mem_removed >= mem_before:
        failures.append(f"remove: memory_allocated {mem_removed} after the removal, {mem_before} before")
    t_restart = time.perf_counter()
    fleet.replicas[0].restart()
    torch.cuda.synchronize()
    restart_ms = (time.perf_counter() - t_restart) * 1e3
    mem_restarted = memory()
    check_memory("restart", mem_before, mem_restarted)
    emit("fleet", part="remove", card=smi, after_steps=FLEET_REMOVE_AFTER, in_flight=in_flight,
         wall_s=wall_c, remove_ms=remove_ms, add_replica_ms=add_ms, restart_ms=restart_ms,
         failovers=stats_c["fleet_failover_total"], scale_downs=stats_c["scale_downs"],
         divergences_vs_no_fault=div_c, removed_pool=pool_removed, memory_before=mem_before,
         memory_after_removal=mem_removed, memory_after_add=mem_added, memory_after_restart=mem_restarted,
         **launches["remove"])

    # (d) a replica evacuated mid-flight, resized 4 -> 6 -> 4, serves what it lost
    lost = list(range(FLEET_SLOTS))
    t0 = start()
    reqs = [fleet.submit(prompts[i], configs[i]) for i in lost]
    for _ in range(FLEET_REMOVE_AFTER):
        fleet.step()
    victim = max(fleet.replicas, key=lambda r: len(r.handles))
    in_flight_d = len(victim.handles)
    evacuated = fleet.remove_replica(victim.replica_id).engine
    del victim
    evacuated_frees = dict(evacuated._pool.frees_by_cause)
    if in_flight_d == 0 or not evacuated_frees.get("scale_down"):
        failures.append(f"resize: the evacuated replica held {in_flight_d} requests, freed {evacuated_frees}")
    fleet.run_until_idle()
    resize_ms = []
    for n in FLEET_RESIZE:
        t_resize = time.perf_counter()
        evacuated.resize_slots(n)
        torch.cuda.synchronize()
        resize_ms.append((time.perf_counter() - t_resize) * 1e3)
    again = [evacuated.submit(prompts[i], configs[i]) for i in lost]
    evacuated.run_until_idle()
    wall_d = stop("resize", t0)
    div_d = held("resize", again, rows_a, lost) + held("resize_fleet", reqs, rows_a, lost)
    pools_d = leak_free("resize", [evacuated] + [r.engine for r in fleet.replicas])
    if evacuated.slots != FLEET_RESIZE[-1] or evacuated._pool.slots != FLEET_RESIZE[-1]:
        failures.append(f"resize: {evacuated.slots} slots, pool of {evacuated._pool.slots}")
    emit("fleet", part="resize", card=smi, slots=[FLEET_SLOTS, *FLEET_RESIZE], resize_ms=resize_ms,
         requests=len(lost), evacuated_in_flight=in_flight_d, evacuated_frees=evacuated_frees, wall_s=wall_d, divergences_vs_no_fault=div_d, pools=pools_d, **launches["resize"])
    del fleet, evacuated, reqs, again
    gc.collect()
    torch.cuda.empty_cache()

    # (e) the streaming gateway over a fleet: concurrent SSE streams, one cut
    chaos = ChaosRegistry()
    chaos.disconnect_stream(FLEET_STREAMS + 1, after_tokens=FLEET_CUT_AFTER)
    tracer = Tracer()
    fleet = FleetRouter([factory] * 2, registry=MetricsRegistry(), tracer=tracer)
    gateway = StreamingGateway(fleet, registry=fleet.registry, tracer=tracer, chaos=chaos).run_in_thread()
    try:
        client = GatewayHttpClient(gateway.host, gateway.port, mode="sse")
        t0 = start()
        handles = [client.submit(prompts[i], configs[i]) for i in range(FLEET_STREAMS + 1)]
        deadline = time.monotonic() + FLEET_GATEWAY_TIMEOUT_S
        while client.pending() and time.monotonic() < deadline:
            time.sleep(0.01)
        while time.monotonic() < deadline and (
                gateway.stats()["streams_completed"] + gateway.stats()["streams_cancelled"] < len(handles)):
            time.sleep(0.01)
        while fleet.pending() and time.monotonic() < deadline:
            time.sleep(0.01)
        wall_e = stop("gateway", t0)
        conn = http.client.HTTPConnection(gateway.host, gateway.port, timeout=30)
        conn.request("GET", "/healthz")
        resp = conn.getresponse()
        healthz = (resp.status, json.loads(resp.read()))
        conn.close()
        conn = http.client.HTTPConnection(gateway.host, gateway.port, timeout=30)
        conn.request("GET", "/metrics")
        resp = conn.getresponse()
        metrics = (resp.status, resp.read().decode())
        conn.close()
        gw_stats = gateway.stats()
    finally:
        gateway.close()
    if gateway._thread.is_alive() or gateway.driver_errors:
        failures.append(f"gateway: thread alive {gateway._thread.is_alive()}, errors {gateway.driver_errors}")
    streams = handles[:FLEET_STREAMS]
    div_e = held("gateway", streams, rows_a, list(range(FLEET_STREAMS)))
    cut = handles[FLEET_STREAMS]
    events = sorted((sp.attrs["stream_id"], sp.status) for sp in tracer.spans("gateway.request"))
    freed = [r.engine._pool.frees_by_cause.get("cancelled", 0) for r in fleet.replicas]
    pools_e = leak_free("gateway", [r.engine for r in fleet.replicas])
    reg = fleet.registry
    socket_p50, engine_p50 = (reg.percentile("gateway_socket_ttft_ms", 50.0),
                              reg.percentile("serving_ttft_ms", 50.0))
    families = sorted({line.split()[2] for line in metrics[1].splitlines()
                       if line.startswith("# HELP gateway_")})
    if (cut.done and cut.status == "ok") or len(cut.tokens) != FLEET_CUT_AFTER - 1 \
            or events[-1] != (FLEET_STREAMS + 1, "cancelled") \
            or reg.counter("fleet_requests_cancelled_total") != 1 or not any(freed) \
            or any(h["slots_active"] for h in healthz[1]["replica_detail"]):
        failures.append(f"gateway: cut stream {cut.status} with {len(cut.tokens)} tokens, events {events}, "
                        f"cancelled {reg.counter('fleet_requests_cancelled_total')}, freed {freed}")
    if gw_stats["streams"] != FLEET_STREAMS + 1 or gw_stats["streams_completed"] != FLEET_STREAMS \
            or gw_stats["streams_cancelled"] != 1:
        failures.append(f"gateway: streams {gw_stats}")
    if healthz[0] != 200 or metrics[0] != 200 or not set(GATEWAY_COUNTERS) <= set(families):
        failures.append(f"gateway: /healthz {healthz[0]}, /metrics {metrics[0]} naming {families}")
    if socket_p50 is None or engine_p50 is None:
        failures.append(f"gateway: TTFT p50 socket {socket_p50}, engine {engine_p50}")
    emit("fleet", part="gateway", card=smi, streams=FLEET_STREAMS, cut_stream=FLEET_STREAMS + 1,
         cut_after_tokens=FLEET_CUT_AFTER, cut_client_status=cut.status, cut_tokens=len(cut.tokens),
         wall_s=wall_e, gateway_socket_ttft_ms_p50=socket_p50, serving_ttft_ms_p50=engine_p50,
         socket_minus_engine_ttft_ms=None if None in (socket_p50, engine_p50) else socket_p50 - engine_p50,
         gateway_stats={k: gw_stats[k] for k in ("streams", "streams_completed", "streams_cancelled",
                                                  "bytes_sent", "driver_errors")},
         healthz_status=healthz[0], metrics_gateway_families=families, events=events, cancelled_pages=freed,
         divergences_vs_no_fault=div_e, pools=pools_e, **launches["gateway"])
    del fleet, gateway, handles, streams, cut
    gc.collect()
    torch.cuda.empty_cache()
    if failures:
        raise AssertionError("fleet: " + "; ".join(failures))
    return launches


# the cli phase: the CLM family's CLI at clm-base width over
# SHALLOW_SERVE_LAYERS of its 16 layers (fit, validate, test, serve) and the
# symbolic family's fit at GiantMIDI width
CLI_MODEL = ["--model.num_channels=896", "--model.max_latents=512", "--model.num_heads=8",
             f"--model.num_self_attention_layers={SHALLOW_SERVE_LAYERS}"]
# the synthetic corpus's 27 characters take 27 of the 262 byte ids: AdamW at
# phase 13's 1e-4 overshot after its second update (6.39 -> 5.83 -> 9.34 by
# step 6 on an NVIDIA H100), so the CLI's fit peaks at 2e-5
CLI_LR = 2e-5
CLI_WARMUP = 2
CLI_TRAIN = [f"--trainer.max_steps={TRAIN_STEPS}", "--trainer.grad_accum_steps=2",
             "--trainer.grad_clip_norm=1.0", "--trainer.log_every_n_steps=1",
             f"--trainer.val_check_interval={TRAIN_STEPS}", "--trainer.limit_val_batches=1",
             "--trainer.limit_test_batches=1", "--trainer.enable_tensorboard=false", f"--optimizer.lr={CLI_LR}",
             f"--lr_scheduler.warmup_steps={CLI_WARMUP}"]
# 8 ragged byte prompts (496 latents in a 1000 or 1008 bucket: latent
# growth, boundary and window steps) and one past the largest bucket
CLI_PROMPT_LENS = (520, 600, 700, 780, 850, 900, 940, 960, 1010)
CLI_NEW_TOKENS = 32
CLI_LATENTS = 496
CLI_SERVE = [f"--serve.max_new_tokens={CLI_NEW_TOKENS}", f"--serve.num_latents={CLI_LATENTS}",
             "--serve.warmup=false"]
CLI_ENGINES = {
    "bucket": ["--serve.engine=bucket", "--serve.prompt_buckets=512,1000", "--serve.batch_buckets=4"],
    "slots": ["--serve.engine=slots", "--serve.prompt_buckets=" + ",".join(map(str, SLOT_BUCKETS)),
              "--serve.slots=4", "--serve.kv_layout=paged", "--serve.speculation=off"],
}
#: the serve runs of the cli phase: each engine, then the slot engine's
#: flags again behind the fleet router and its autoscaler
CLI_SERVE_RUNS = ("serve_bucket", "serve_slots", "serve_fleet")
CLI_FLEET = ["--serve.replicas=2", "--serve.autoscale.max=3", "--serve.autoscale.min=2"]
CLI_SAM_STEPS = 4
#: the `python -m ... serve` process serves the bucket run's first batch
CLI_SUBPROCESS_PROMPTS = 4
# the CLI fit's --obs.* flags (events and snapshot under its root dir; the
# trigger fences each step and would arm on a 3x p95 regression)
CLI_FIT_OBS = ["--obs.events_path=events.jsonl", "--obs.snapshot_every_s=5",
               "--obs.profile_on_regress_factor=3.0"]


def cli_run(torch, flash, ragged, main, argv, training=None) -> tuple:
    """One CLI call, ``main(argv)``, with every launch count set to 0 just
    before it; with ``training``, the launches of ``Trainer.validate`` calls
    are counted apart. Returns what the call returned and its record: wall
    time, launches (validation's excluded), K1's, K2/K3's and K4's routes."""
    val_counts = {"k1": 0, "k2": 0, "k3": 0}
    validate = training.Trainer.validate if training is not None else None

    def counted_validate(self, data):
        before = read_counts(flash)
        out = validate(self, data)
        for key, n in read_counts(flash).items():
            val_counts[key] += n - before[key]
        return out

    if training is not None:
        training.Trainer.validate = counted_validate
    reset_counts(flash)
    reset_k4_counts(ragged)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        out = main(argv)
        torch.cuda.synchronize()
    finally:
        if training is not None:
            training.Trainer.validate = validate
    wall_s = time.perf_counter() - t0
    counts = read_counts(flash)
    return out, {
        "wall_s": wall_s,
        "launches": {**{k: counts[k] - val_counts[k] for k in counts},
                     "k4": ragged.ragged_paged_attention.launches},
        "validation_launches": val_counts,
        "k1_routes": dict(flash.flash_attention.route_launches),
        "bwd_routes": read_bwd_routes(flash),
        "k4_routes": dict(ragged.ragged_paged_attention.route_launches),
    }


def _fit_failures(rec: dict, steps: int, attends: int, k1_routes: Optional[dict] = None,
                  bwd_routes: Optional[dict] = None) -> list:
    """A CLI fit's launch gates: K1, K2 and K3 ``attends`` times a step
    (validation apart); K1's launches by route in the shares of
    ``k1_routes`` (launches a step by route; validation's forwards the same
    shares) and K2/K3's as ``bwd_routes`` a step; both default to every
    launch on ``wgmma`` (a bf16 fit)."""
    failures = []
    k1_routes = k1_routes or {"wgmma": attends}
    bwd_routes = bwd_routes or {"wgmma": attends}
    per_step = {k: rec["launches"][k] / steps for k in ("k1", "k2", "k3")}
    if per_step != {"k1": attends, "k2": attends, "k3": attends}:
        failures.append(f"launches per step {per_step}, want {attends}")
    k1_all = rec["launches"]["k1"] + rec["validation_launches"]["k1"]
    if (any(rec["k1_routes"][r] * attends != k1_all * n for r, n in k1_routes.items())
            or sum(rec["k1_routes"].values()) != k1_all):
        failures.append(f"K1 routes {rec['k1_routes']}: want {k1_routes} of every {attends}")
    for key, by_route in rec["bwd_routes"].items():
        if (any(by_route[r] != n * steps for r, n in bwd_routes.items())
                or sum(by_route.values()) != rec["launches"][key]):
            failures.append(f"{key.upper()} routes {by_route}: want {bwd_routes} a step")
    return failures


def _cli_losses(root: Path) -> tuple:
    rows = [json.loads(line) for line in open(root / "metrics.jsonl")]
    return [r["train/loss"] for r in rows if "train/loss" in r], [r["val/loss"] for r in rows if "val/loss" in r]


def cli_serve(torch, flash, ragged, engine_mod, clm_script, ckpt: Path, prompts_file: Path, engine: str,
              extra=()) -> tuple:
    """``serve --ckpt`` in process (``extra``: more flags): the JSON lines it
    printed, the requests it submitted (recorded at ``ServingEngine.submit``)
    and the run's record."""
    import contextlib
    import io

    reqs = []
    submit = engine_mod.ServingEngine.submit

    def recording_submit(self, *args, **kwargs):
        req = submit(self, *args, **kwargs)
        reqs.append(req)
        return req

    out = io.StringIO()
    engine_mod.ServingEngine.submit = recording_submit
    try:
        with contextlib.redirect_stdout(out):
            _, rec = cli_run(torch, flash, ragged, clm_script.main,
                             ["serve", f"--ckpt={ckpt}", f"--serve.prompts={prompts_file}", *CLI_SERVE,
                              *CLI_ENGINES[engine], *extra])
    finally:
        engine_mod.ServingEngine.submit = submit
    lines = [json.loads(line) for line in out.getvalue().splitlines()]
    return lines, reqs, rec


def _serve_failures(lines, rows, decode, engine: str, rec: dict) -> list:
    """The serve gates shared by the in-process runs: one line a prompt and
    the ``serve_stats`` line last, each feasible prompt's completion the
    decoded tokens its request got, the infeasible one an error record, K1
    on split and tf32x3 only, K4 on split and tc under the paged slot engine."""
    failures = []
    results, stats = lines[:-1], lines[-1].get("serve_stats")
    n_ok = len(CLI_PROMPT_LENS) - 1
    if stats is None or len(results) != len(CLI_PROMPT_LENS) or len(rows) != n_ok:
        return [f"{len(results)} result lines, {len(rows)} requests, serve_stats {stats is not None}"]
    for i, (line, row) in enumerate(zip(results, rows)):
        if line["status"] != "ok" or line["completion"] != decode(row):
            failures.append(f"line {i}: {line['status']}, completion unlike the request's tokens")
    last = results[-1]
    if last["status"] != "rejected" or "exceeds the largest bucket" not in last.get("error", ""):
        failures.append(f"the {CLI_PROMPT_LENS[-1]}-byte prompt gave {last}")
    if stats["completed"] != n_ok or stats["rejected"] != 1:
        failures.append(f"serve_stats completed {stats['completed']}, rejected {stats['rejected']}")
    k1, k1_routes = rec["launches"]["k1"], rec["k1_routes"]
    if not (k1_routes["split"] > 0 and k1_routes["tf32x3"] > 0 and k1_routes["split"] + k1_routes["tf32x3"] == k1):
        failures.append(f"K1 routes {k1_routes}: fp32 serving takes split and tf32x3 only")
    k4_routes = rec["k4_routes"]
    if engine == "slots" and not (k4_routes["split"] > 0 and k4_routes["tc"] > 0 and k4_routes["simt"] == 0):
        failures.append(f"K4 routes {k4_routes}: decode rows take split, window rows tc, never simt")
    if engine == "bucket" and rec["launches"]["k4"]:
        failures.append(f"K4 launched {rec['launches']['k4']} times in the bucket engine")
    return failures


def obs_cli(clm_script, argv) -> str:
    """One ``obs report|incident|timeline`` call through the CLI; what it printed."""
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        clm_script.main(argv)
    return out.getvalue()


def cli_phase(torch, flash, ragged, gen_mod, engine_mod, training, parallel, root: Path, smi: str) -> dict:
    """Phase 16: the port's CLI, driven through ``main(argv)`` as ``python
    -m`` calls it (and once as a real ``python -m`` process). Returns each
    run's record (``fit``, ``validate``, ``test``, ``serve_bucket``,
    ``serve_slots``, ``symbolic_fit``)."""
    import dataclasses
    import gc
    import os

    import numpy as np

    from perceiver_io_tpu_torch.data.text.sources import SyntheticTextDataModule
    from perceiver_io_tpu_torch.data.text.tokenizers import ByteTokenizer
    from perceiver_io_tpu_torch.models import model_for_config
    from perceiver_io_tpu_torch.models.text.clm import CausalLanguageModel
    from perceiver_io_tpu_torch.scripts.audio import symbolic as sam_script
    from perceiver_io_tpu_torch.scripts.text import clm as clm_script

    t_phase = time.perf_counter()
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    runs = {}
    data = ["--data=synthetic", f"--data.dataset_dir={root / 'data'}", "--data.max_seq_len=1024",
            "--data.batch_size=8", "--data.num_train_docs=32", "--data.num_valid_docs=8"]
    common = [*data, *CLI_MODEL, *CLI_TRAIN]

    # (a) fit with --obs.*, then the same fit through Trainer.fit directly
    state, runs["fit"] = cli_run(torch, flash, ragged, clm_script.main,
                                 ["fit", *common, f"--trainer.default_root_dir={root / 'fit'}", *CLI_FIT_OBS],
                                 training)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    losses, val_loss = _cli_losses(root / "fit")
    ckpt = root / "fit" / "checkpoints"
    weights, cfg = training.load_pretrained(str(ckpt))
    attends = 2 * (1 + cfg.num_self_attention_layers)
    failures = _fit_failures(runs["fit"], TRAIN_STEPS, attends)
    if not (len(losses) == TRAIN_STEPS and all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]):
        failures.append(f"losses {losses}")
    if cfg.vocab_size != ByteTokenizer.vocab_size:
        failures.append(f"vocab {cfg.vocab_size}: the link should give the byte tokenizer's 262")
    # --obs.*: one fenced trainer.step span a step, one trace, a final snapshot
    from perceiver_io_tpu_torch.observability import read_events_jsonl

    fit_events = read_events_jsonl(str(root / "fit" / "events.jsonl"))
    step_spans = [r for r in fit_events if r["span"] == "trainer.step"]
    fit_snapshot = json.loads((root / "fit" / "metrics_snapshot.json").read_text())
    if [r["attrs"]["step"] for r in step_spans] != list(range(1, TRAIN_STEPS + 1)) \
            or any(r["attrs"]["measures"] != "fenced" for r in step_spans):
        failures.append(f"trainer.step spans {[r['attrs'] for r in step_spans]}")
    if len({r["trace_id"] for r in fit_events}) != 1 \
            or fit_snapshot["counters"].get("trainer_steps_total") != TRAIN_STEPS:
        failures.append(f"fit telemetry: {len(fit_events)} spans, snapshot counters {fit_snapshot['counters']}")
    emit("cli", part="fit", card=smi, model=dataclasses.asdict(cfg), steps=TRAIN_STEPS, losses=losses,
         val_loss=val_loss, wall_s=runs["fit"]["wall_s"], obs_flags=CLI_FIT_OBS,
         trainer_step_spans=len(step_spans), fit_spans=sorted({r["span"] for r in fit_events}),
         trainer_step_ms=fit_snapshot["histograms"].get("trainer_step_ms"),
         launches_per_step={k: runs["fit"]["launches"][k] / TRAIN_STEPS for k in ("k1", "k2", "k3")},
         **{k: v for k, v in runs["fit"].items() if k != "wall_s"})
    if failures:
        raise AssertionError("cli fit: " + "; ".join(failures))
    dm = SyntheticTextDataModule(dataset_dir=str(root / "data"), max_seq_len=1024, batch_size=8,
                                 num_train_docs=32, num_valid_docs=8, task="clm", padding_side="left")
    dm.prepare_data()
    dm.setup()
    direct = train_fit(torch, flash, training, parallel, CausalLanguageModel, cfg, torch.bfloat16,
                       root / "direct", dm.train_dataloader(),
                       list(itertools.islice(iter(dm.train_dataloader()), 2)),
                       list(itertools.islice(iter(dm.val_dataloader()), 1)), lr=CLI_LR,
                       warmup_steps=CLI_WARMUP, phase="cli_direct_fit")
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, direct["losses"]))
    emit("cli", part="fit_vs_trainer", card=smi, cli_losses=losses, trainer_losses=direct["losses"],
         max_rel_diff=rel, tol=1e-6)
    if len(direct["losses"]) != len(losses) or rel > 1e-6:
        raise AssertionError(f"cli fit losses {losses} differ from Trainer.fit's {direct['losses']}")

    # (b) validate and test on the checkpoint
    for sub in ("validate", "test"):
        metrics, runs[sub] = cli_run(torch, flash, ragged, clm_script.main,
                                     [sub, *common, f"--ckpt={ckpt}",
                                      f"--trainer.default_root_dir={root / sub}"])
        key = "loss" if sub == "validate" else "test_loss"
        emit("cli", part=sub, card=smi, metrics=metrics, wall_s=runs[sub]["wall_s"],
             k1_launches=runs[sub]["launches"]["k1"], k1_routes=runs[sub]["k1_routes"])
        if sorted(metrics) != [key] or not math.isfinite(metrics[key]) \
                or runs[sub]["k1_routes"]["wgmma"] != runs[sub]["launches"]["k1"] or not runs[sub]["launches"]["k1"]:
            raise AssertionError(f"cli {sub}: {metrics}, K1 routes {runs[sub]['k1_routes']}")
        gc.collect()
        torch.cuda.empty_cache()

    # (c) serve on both engines against per-request generate() from the checkpoint
    tok = ByteTokenizer(padding_side="left")
    rng = np.random.default_rng(29)
    texts = ["".join(rng.choice(list("abcdefghijklmnopqrstuvwxyz "), size=n)) for n in CLI_PROMPT_LENS]
    prompts_file = root / "prompts.txt"
    prompts_file.write_text("\n".join(texts) + "\n")
    prompts = [np.asarray(tok.encode(t), np.int32) for t in texts[:-1]]
    gcfg = gen_mod.GenerationConfig(max_new_tokens=CLI_NEW_TOKENS, num_latents=CLI_LATENTS,
                                    pad_token_id=tok.pad_token_id, eos_token_id=tok.eos_token_id)
    model = model_for_config(cfg)
    model.load_state_dict(weights)
    model.eval()
    del weights
    refs = [gen_mod.generate(model, p[None], gcfg)[0].cpu().numpy() for p in prompts]

    def decode(row):
        return tok.decode([t for t in np.asarray(row).tolist() if t != tok.pad_token_id])

    served = {}
    obs_paths = {k: root / f"serve_{k}" for k in ("events.jsonl", "timeline.jsonl", "snapshot.json")}
    serve_obs = [f"--obs.events_path={obs_paths['events.jsonl']}", "--obs.timeline.steps=4096",
                 f"--obs.timeline.export={obs_paths['timeline.jsonl']}",
                 f"--obs.snapshot_path={obs_paths['snapshot.json']}"]
    for engine in ("bucket", "slots"):
        lines, reqs, rec = cli_serve(torch, flash, ragged, engine_mod, clm_script, ckpt, prompts_file, engine,
                                     serve_obs if engine == "slots" else ())
        runs[f"serve_{engine}"] = rec
        rows = [r.result for r in reqs]
        failures = _serve_failures(lines, rows, decode, engine, rec)
        if engine == "slots" and not all(line.get("trace_id") for line in lines[:-1]):
            failures.append(f"trace ids {[line.get('trace_id') for line in lines[:-1]]}: each line carries one")
        if engine == "bucket":
            mismatches = sum(int((row != ref).any()) for row, ref in zip(rows, refs))
            if mismatches:
                failures.append(f"{mismatches} requests differ from generate()")
            divergences = None
        else:
            divergences = _divergences(torch, gen_mod, model, rows, refs, prompts, [gcfg] * len(prompts), failures)
        stats = lines[-1].get("serve_stats", {})
        served[engine] = lines
        emit("cli", part=f"serve_{engine}", card=smi, requests=stats.get("completed"),
             rejected=stats.get("rejected"), tokens=stats.get("tokens_generated"), wall_s=rec["wall_s"],
             tokens_per_s=stats.get("tokens_generated", 0) / rec["wall_s"],
             serve_stats_wall_s=stats.get("wall_s"), ttft_ms_p50=stats.get("ttft_ms", {}).get("p50"),
             k1_launches=rec["launches"]["k1"], k1_route_launches=rec["k1_routes"],
             k4_launches=rec["launches"]["k4"], k4_route_launches=rec["k4_routes"],
             divergences_vs_generate=divergences,
             completions_equal_references=sum(line.get("completion") == decode(ref)
                                              for line, ref in zip(lines, refs)))
        if failures:
            raise AssertionError(f"cli serve {engine}: " + "; ".join(failures))
    # the slots run behind the fleet router and its autoscaler: the same lines
    lines, reqs, rec = cli_serve(torch, flash, ragged, engine_mod, clm_script, ckpt, prompts_file, "slots",
                                 CLI_FLEET)
    runs["serve_fleet"] = rec
    failures = _serve_failures(lines, [r.result for r in reqs], decode, "slots", rec)

    def clean(ls):
        return [{k: v for k, v in line.items() if k != "trace_id"} for line in ls[:-1]]

    stats = lines[-1].get("serve_stats", {})
    if clean(lines) != clean(served["slots"]):
        failures.append("the fleet's lines differ from the single slot engine's")
    if stats.get("engine") != "fleet" or stats.get("autoscaler") is None or stats.get("replicas", 0) < 2:
        failures.append(f"serve_stats engine {stats.get('engine')}, replicas {stats.get('replicas')}, "
                        f"autoscaler {stats.get('autoscaler')}")
    emit("cli", part="serve_fleet", card=smi, flags=CLI_FLEET, requests=stats.get("completed"),
         rejected=stats.get("rejected"), wall_s=rec["wall_s"], replicas=stats.get("replicas"),
         completed_by_replica=stats.get("completed_by_replica"), autoscaler=stats.get("autoscaler"),
         ttft_ms_p50=stats.get("ttft_ms", {}).get("p50"), lines_equal_single_engine=clean(lines) == clean(
             served["slots"]), k1_launches=rec["launches"]["k1"], k1_route_launches=rec["k1_routes"],
         k4_launches=rec["launches"]["k4"], k4_route_launches=rec["k4_routes"])
    if failures:
        raise AssertionError("cli serve fleet: " + "; ".join(failures))
    del model
    gc.collect()
    torch.cuda.empty_cache()

    # obs report and obs timeline over what the observed slots run wrote
    report = obs_cli(clm_script, ["obs", "report", f"--events={obs_paths['events.jsonl']}",
                                  f"--snapshot={obs_paths['snapshot.json']}"])
    timeline = obs_cli(clm_script, ["obs", "timeline", f"--timeline={obs_paths['timeline.jsonl']}",
                                    f"--events={obs_paths['events.jsonl']}"])
    emit("cli", part="obs_reports", card=smi, report_lines=len(report.splitlines()),
         report_sections=[l for l in report.splitlines() if l.startswith("== ")],
         timeline_lines=len(timeline.splitlines()),
         timeline_sections=[l for l in timeline.splitlines() if l.startswith("== ")],
         trace_ids=[line.get("trace_id") for line in served["slots"][:-1]])
    for name, text, section in (("report", report, "== requests =="), ("timeline", timeline, "== slot gantt ==")):
        if section not in text:
            raise AssertionError(f"obs {name} over the serve run lacks {section!r}:\n{text[:2000]}")

    # the bucket run's first batch once more as a real `python -m ... serve`
    # process (the same 4 prompts in one batch of the same bucket: the same
    # arithmetic)
    first = root / "prompts_first_batch.txt"
    first.write_text("\n".join(texts[:CLI_SUBPROCESS_PROMPTS]) + "\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [str(ROOT), env.get("PYTHONPATH")]))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "perceiver_io_tpu_torch.scripts.text.clm", "serve",
                           f"--ckpt={ckpt}", f"--serve.prompts={first}", *CLI_SERVE,
                           *CLI_ENGINES["bucket"]],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    wall_s = time.perf_counter() - t0
    lines = [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]
    same = lines[:-1] == served["bucket"][:CLI_SUBPROCESS_PROMPTS]
    emit("cli", part="serve_subprocess", card=smi, returncode=proc.returncode, wall_s=wall_s,
         lines=len(lines), lines_equal_in_process=same, stderr_tail=proc.stderr.splitlines()[-8:],
         serve_stats_parses=bool(lines) and "serve_stats" in lines[-1])
    if proc.returncode != 0 or not same or not lines or "serve_stats" not in lines[-1]:
        raise AssertionError(f"python -m ... serve: rc {proc.returncode}, equal {same}; "
                             f"stderr {proc.stderr[-2000:]}")

    # (d) the symbolic family's fit at GiantMIDI width
    sam_argv = ["fit", "--data=synthetic", f"--data.dataset_dir={root / 'sam_data'}", "--data.max_seq_len=6144",
                "--data.min_seq_len=4096", "--data.batch_size=8", "--data.num_train_pieces=8",
                "--data.num_valid_pieces=4", "--data.num_test_pieces=0", "--data.mean_piece_len=16384",
                "--data.shard_index=0", "--data.shard_count=1", "--model.num_heads=8",
                f"--model.num_self_attention_layers={SYMBOLIC_LAYERS}", f"--trainer.max_steps={CLI_SAM_STEPS}",
                "--trainer.grad_accum_steps=2", "--trainer.grad_clip_norm=1.0", "--trainer.log_every_n_steps=1",
                f"--trainer.val_check_interval={CLI_SAM_STEPS}", "--trainer.limit_val_batches=1",
                "--trainer.enable_checkpointing=false", "--trainer.enable_tensorboard=false",
                f"--optimizer.lr={SAM_LR}", f"--lr_scheduler.warmup_steps={SAM_WARMUP}",
                f"--trainer.default_root_dir={root / 'sam_fit'}"]
    state, runs["symbolic_fit"] = cli_run(torch, flash, ragged, sam_script.main, sam_argv, training)
    sam_cfg = state.model.config
    del state
    gc.collect()
    torch.cuda.empty_cache()
    sam_losses, sam_val = _cli_losses(root / "sam_fit")
    sam_attends = 2 * (1 + sam_cfg.num_self_attention_layers)
    failures = _fit_failures(runs["symbolic_fit"], CLI_SAM_STEPS, sam_attends)
    head_dim = sam_cfg.num_channels // sam_cfg.num_heads
    if (sam_cfg.max_seq_len, sam_cfg.max_latents, sam_cfg.num_channels, head_dim) != (6144, 2048, 768, 96):
        failures.append(f"config {sam_cfg}: not GiantMIDI width")
    if not (len(sam_losses) == CLI_SAM_STEPS and all(math.isfinite(x) for x in sam_losses + sam_val)):
        failures.append(f"losses {sam_losses}, validation {sam_val}")
    emit("cli", part="symbolic_fit", card=smi, model=dataclasses.asdict(sam_cfg), head_dim=head_dim,
         steps=CLI_SAM_STEPS, losses=sam_losses, val_loss=sam_val, wall_s=runs["symbolic_fit"]["wall_s"],
         launches_per_step={k: runs["symbolic_fit"]["launches"][k] / CLI_SAM_STEPS for k in ("k1", "k2", "k3")},
         **{k: v for k, v in runs["symbolic_fit"].items() if k != "wall_s"})
    if failures:
        raise AssertionError("cli symbolic fit: " + "; ".join(failures))
    emit("cli", part="done", card=smi, seconds=time.perf_counter() - t_phase)
    return runs


# The masked LM at language-perceiver width (deepmind/language-perceiver,
# HF PerceiverForMaskedLM; perceiver_io_tpu/convert/hf_import.py
# mlm_config_from_hf, docs/pretrained-models.md:15,24-26): the byte
# vocabulary (262), 2048 context, d_model 768, 256 latents x 1280 channels,
# 26 self-attends in one block, 8 heads over qk 256 (d = 32) with v 1280 in
# the encoder (dv = 160) and d_model in the decoder (dv = 96), tied
# embeddings, no decoder attention residual. Random weights from a seed;
# attention dropout 0 (with dropout the attends take the plain path).
MLM_WIDTH = {"encoder.num_input_channels": 768, "encoder.num_cross_attention_heads": 8,
             "encoder.num_cross_attention_qk_channels": 256, "encoder.num_cross_attention_v_channels": 1280,
             "encoder.num_self_attention_heads": 8, "encoder.num_self_attention_qk_channels": 256,
             "encoder.num_self_attention_v_channels": 1280, "encoder.num_self_attention_layers_per_block": 26,
             "decoder.num_cross_attention_heads": 8, "decoder.num_cross_attention_qk_channels": 256,
             "decoder.num_cross_attention_v_channels": 768, "decoder.cross_attention_residual": False,
             "num_latents": 256, "num_latent_channels": 1280}
MLM_FLAGS = [f"--model.{k}={str(v).lower() if isinstance(v, bool) else v}" for k, v in MLM_WIDTH.items()]
MLM_SEQ = 2048
MLM_ATTENDS = 28  # a forward: the encoder's cross attend, its 26 self-attends, the decoder's cross attend
MLM_RAGGED_N = 1500
MLM_TEXT_LENS = (512, 700, 900, 1100, 1300, 1500, 1800, 2048)
MLM_TOP_K = 5
MLM_MASKS = 6  # masked words a text


def language_perceiver_config(config_mod, common_mod, mlm_mod):
    enc = {k.split(".", 1)[1]: v for k, v in MLM_WIDTH.items() if k.startswith("encoder.")}
    dec = {k.split(".", 1)[1]: v for k, v in MLM_WIDTH.items() if k.startswith("decoder.")}
    return config_mod.PerceiverIOConfig(
        common_mod.TextEncoderConfig(vocab_size=262, max_seq_len=MLM_SEQ, **enc),
        mlm_mod.TextDecoderConfig(vocab_size=262, max_seq_len=MLM_SEQ, **dec),
        num_latents=MLM_WIDTH["num_latents"], num_latent_channels=MLM_WIDTH["num_latent_channels"])


def mlm_forward(torch, flash, mlm_mod, cfg) -> dict:
    """(a) one forward of 4 rows at n = 2048 and at a ragged n, right pads on
    two rows, fp32 and bf16: the kernels against ``attention_impl="xla"``
    at the symbolic phase's gates, 28 K1 launches a forward (1 cross + 26
    self + 1 decoder), each on the route the type picks."""
    g = torch.Generator(device="cuda").manual_seed(3)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        tname = str(dtype).split(".")[-1]
        model = mlm_mod.MaskedLanguageModel(cfg, dtype=dtype, seed=0).eval()
        params = sum(p.numel() for p in model.parameters())
        for n in (MLM_SEQ, MLM_RAGGED_N):
            x = torch.randint(0, 256, (4, n), generator=g, device="cuda")
            pad = torch.zeros(4, n, dtype=torch.bool, device="cuda")
            pad[1, n - 300:] = True
            pad[2, n // 2:] = True
            set_attention_impl(model, "auto")
            reset_counts(flash)
            with torch.no_grad():
                logits = model(x, pad_mask=pad)
                torch.cuda.synchronize()
                launches, routes = flash.flash_attention.launches, dict(flash.flash_attention.route_launches)
                set_attention_impl(model, "xla")
                plain = model(x, pad_mask=pad)
            err = (logits.float() - plain.float()).abs().max().item()
            tol = 1e-3 if dtype == torch.float32 else 8 * bf16_ulp(plain.float().abs().max().item())
            finite = bool(torch.isfinite(logits).all().item())
            expected = "wgmma" if dtype == torch.bfloat16 else "tf32x3"
            line = dict(part="forward", dtype=tname, n=n, params=params, logits_shape=list(logits.shape),
                        max_abs_err_vs_plain=err, tol=tol, logits_max_abs=plain.float().abs().max().item(),
                        finite=finite, k1_launches=launches, k1_route_launches=routes)
            emit("mlm", **line)
            if not (err <= tol and finite and tuple(logits.shape) == (4, n, 262)) \
                    or launches != MLM_ATTENDS or routes[expected] != launches:
                raise AssertionError(f"mlm forward {tname} n={n}: max|d| {err} (tol {tol}), finite {finite}, "
                                     f"shape {tuple(logits.shape)}, K1 {launches} launches {routes} "
                                     f"(want {MLM_ATTENDS} on {expected})")
            out[f"{tname}_{n}"] = line
            del logits, plain
        set_attention_impl(model, "auto")
        if dtype == torch.float32:
            out["model"] = model
        else:
            del model
        torch.cuda.empty_cache()
    return out


def _mlm_texts():
    """8 masked texts of 512-2048 bytes: words over a few letters,
    ``MLM_MASKS`` of them replaced by ``<mask>`` (one token each, so a text
    stays within its byte count of tokens)."""
    import numpy as np

    rng = np.random.default_rng(41)
    texts = []
    for n in MLM_TEXT_LENS:
        words = []
        while sum(len(w) + 1 for w in words) < n:
            words.append("".join(rng.choice(list("etaoinshrdlu"), size=int(rng.integers(2, 8)))))
        words = " ".join(words)[:n].split(" ")
        for i in rng.choice(np.arange(1, len(words) - 1), size=MLM_MASKS, replace=False):
            words[i] = "<mask>"
        texts.append(" ".join(words))
    return texts


def mlm_fill(torch, flash, pipelines_mod, preprocessor_cls, tokenizer_cls, model, smi: str) -> dict:
    """(b) ``pipeline("fill-mask")`` over 8 masked texts of 512-2048 bytes,
    top-5, on the fp32 model: the fillings equal the ``xla`` run's. A text
    that differs must differ in the top-5 ids of a masked position, and at
    every masked position and rank where the ``auto`` and ``xla`` forwards'
    ids differ, the xla logits of the two ids must lie within ``NEAR_TIE``;
    texts/s of the batch and the per-text latency p50."""
    import numpy as np

    texts = _mlm_texts()
    prep = preprocessor_cls(tokenizer_cls(), max_seq_len=MLM_SEQ)
    pipe = pipelines_mod.pipeline("fill-mask", model, prep)
    pipe(texts[:1], top_k=MLM_TOP_K)  # warm-up
    reset_counts(flash)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    filled = pipe(texts, top_k=MLM_TOP_K)
    batch_s = time.perf_counter() - t0
    launches, routes = flash.flash_attention.launches, dict(flash.flash_attention.route_launches)
    latency = []
    for text in texts:
        t1 = time.perf_counter()
        pipe(text, top_k=MLM_TOP_K)
        latency.append((time.perf_counter() - t1) * 1e3)
    ids, pad = (np.asarray(x) for x in prep.preprocess_batch(texts))
    masked = ids == prep.tokenizer.mask_token_id
    logits = {}
    for impl in ("auto", "xla"):  # the filler's forward, its logits at the masked positions
        set_attention_impl(model, impl)
        try:
            with torch.no_grad():
                logits[impl] = model(torch.as_tensor(ids, device="cuda").long(),
                                     pad_mask=torch.as_tensor(pad, device="cuda")).float().cpu().numpy()[masked]
            if impl == "xla":
                filled_xla = pipe(texts, top_k=MLM_TOP_K)
        finally:
            set_attention_impl(model, "auto")
    top = {impl: np.argsort(-x, axis=-1)[:, :MLM_TOP_K] for impl, x in logits.items()}
    # per masked position and rank: the xla logits' gap between the two runs' ids there
    gap = np.abs(np.take_along_axis(logits["xla"], top["xla"], -1)
                 - np.take_along_axis(logits["xla"], top["auto"], -1))
    diverged = top["auto"] != top["xla"]
    rows = np.nonzero(masked)[0]
    differing = [i for i, (a, b) in enumerate(zip(filled, filled_xla)) if a != b]
    unexcused = sorted({int(rows[p]) for p in np.nonzero((diverged & (gap >= NEAR_TIE)).any(-1))[0]}
                       | {i for i in differing if not diverged[rows == i].any()})
    mask_ok = len(filled) == len(texts) and all(len(f) == MLM_TOP_K for f in filled)
    line = dict(part="fill_mask", card=smi, texts=len(texts), text_bytes=list(MLM_TEXT_LENS), top_k=MLM_TOP_K,
                masked_positions=int(masked.sum()), batch_s=batch_s, texts_per_s=len(texts) / batch_s,
                latency_ms=latency, latency_ms_p50=float(np.median(latency)), k1_launches=launches,
                k1_route_launches=routes, differing_texts=differing,
                diverged_positions=int(diverged.any(-1).sum()), unexcused=unexcused,
                top_k_each=mask_ok, example=[f[:80] for f in filled[0][:2]])
    emit("mlm", **line)
    if unexcused or not mask_ok or launches != MLM_ATTENDS or routes["tf32x3"] != launches:
        raise AssertionError(f"mlm fill-mask: texts {unexcused} differ from the xla run's past a near tie, "
                             f"top-k for each {mask_ok}, K1 {launches} launches {routes}")
    return line


def mlm_cli(torch, flash, ragged, training, parallel, mlm_mod, mlm_script, root: Path, smi: str) -> dict:
    """(c) the MLM CLI's ``fit`` (bf16, 8 steps of 8 x 2048 over the
    synthetic corpus with word masking, the published widths as flags),
    against phase 13's ``train_fit`` with the same arguments (the same
    losses, bit for bit); then ``validate`` / ``test --ckpt``."""
    import dataclasses
    import gc

    from perceiver_io_tpu_torch.data.text.sources import SyntheticTextDataModule

    runs = {}
    data_kw = dict(dataset_dir=str(root / "data"), max_seq_len=MLM_SEQ, batch_size=8, num_train_docs=64,
                   num_valid_docs=8, task="mlm")
    data = [f"--data.{k}={v}" for k, v in data_kw.items()]
    common = ["--data=synthetic", *data, *MLM_FLAGS, *CLI_TRAIN]
    state, runs["fit"] = cli_run(torch, flash, ragged, mlm_script.main,
                                 ["fit", *common, f"--trainer.default_root_dir={root / 'fit'}"], training)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    losses, val_loss = _cli_losses(root / "fit")
    ckpt = root / "fit" / "checkpoints"
    _, cfg = training.load_pretrained(str(ckpt))
    attends = 2 * MLM_ATTENDS
    failures = _fit_failures(runs["fit"], TRAIN_STEPS, attends)
    if not (len(losses) == TRAIN_STEPS and all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]):
        failures.append(f"losses {losses}")
    emit("mlm", part="fit", card=smi, model=dataclasses.asdict(cfg), steps=TRAIN_STEPS, losses=losses,
         val_loss=val_loss, wall_s=runs["fit"]["wall_s"],
         launches_per_step={k: runs["fit"]["launches"][k] / TRAIN_STEPS for k in ("k1", "k2", "k3")},
         **{k: v for k, v in runs["fit"].items() if k != "wall_s"})
    if failures:
        raise AssertionError("mlm cli fit: " + "; ".join(failures))
    fit_dm, aux_dm = (SyntheticTextDataModule(**data_kw) for _ in range(2))
    for dm in (fit_dm, aux_dm):  # the fit's masks come from its own collator, as the CLI's do
        dm.prepare_data()
        dm.setup()
    direct = train_fit(torch, flash, training, parallel, mlm_mod.MaskedLanguageModel, cfg, torch.bfloat16,
                       root / "direct", fit_dm.train_dataloader(),
                       list(itertools.islice(iter(aux_dm.train_dataloader()), 2)),
                       list(itertools.islice(iter(aux_dm.val_dataloader()), 1)), lr=CLI_LR,
                       warmup_steps=CLI_WARMUP, phase="mlm_direct_fit",
                       make_loss=lambda model, cfg: training.mlm_loss_fn(model), attends=attends,
                       tokens_per_step=8 * MLM_SEQ)
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, direct["losses"]))
    emit("mlm", part="fit_vs_trainer", card=smi, cli_losses=losses, trainer_losses=direct["losses"],
         max_rel_diff=rel, bit_equal=losses == direct["losses"])
    if losses != direct["losses"]:
        raise AssertionError(f"mlm cli fit losses {losses} differ from Trainer.fit's {direct['losses']}")
    runs["direct"] = direct
    for sub in ("validate", "test"):
        metrics, runs[sub] = cli_run(torch, flash, ragged, mlm_script.main,
                                     [sub, *common, f"--ckpt={ckpt}", f"--trainer.default_root_dir={root / sub}"])
        key = "loss" if sub == "validate" else "test_loss"
        emit("mlm", part=sub, card=smi, metrics=metrics, wall_s=runs[sub]["wall_s"],
             k1_launches=runs[sub]["launches"]["k1"], k1_routes=runs[sub]["k1_routes"])
        if sorted(metrics) != [key] or not math.isfinite(metrics[key]) \
                or runs[sub]["k1_routes"]["wgmma"] != runs[sub]["launches"]["k1"] \
                or runs[sub]["launches"]["k1"] != MLM_ATTENDS:
            raise AssertionError(f"mlm cli {sub}: {metrics}, K1 {runs[sub]['launches']['k1']} launches "
                                 f"{runs[sub]['k1_routes']}")
        gc.collect()
        torch.cuda.empty_cache()
    return runs


def mlm_phase(torch, flash, ragged, pipelines_mod, training, parallel, root: Path, smi: str) -> dict:
    """Phase 17: the masked LM at language-perceiver width: (a) the forward
    against ``xla`` with 28 K1 launches a forward, (b) ``pipeline("fill-mask")``
    and (c) the MLM CLI's ``fit`` / ``validate`` / ``test``."""
    import gc

    from perceiver_io_tpu_torch.data import text as data_text
    from perceiver_io_tpu_torch.data.text.tokenizers import ByteTokenizer
    from perceiver_io_tpu_torch.models.core import config as config_mod
    from perceiver_io_tpu_torch.models.text import common as common_mod
    from perceiver_io_tpu_torch.models.text import mlm as mlm_mod
    from perceiver_io_tpu_torch.scripts.text import mlm as mlm_script

    t_phase = time.perf_counter()
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    cfg = language_perceiver_config(config_mod, common_mod, mlm_mod)
    forward = mlm_forward(torch, flash, mlm_mod, cfg)
    model = forward.pop("model")
    fill = mlm_fill(torch, flash, pipelines_mod, data_text.TextPreprocessor, ByteTokenizer, model, smi)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    runs = mlm_cli(torch, flash, ragged, training, parallel, mlm_mod, mlm_script, root, smi)
    seconds = time.perf_counter() - t_phase
    emit("mlm", part="done", card=smi, seconds=seconds)
    return {"forward": forward, "fill": fill, "cli": runs, "seconds": seconds}


# the text classifier at published width: the language-perceiver encoder
# (MLM_WIDTH's) and the CLI's decoder, one query of 1280 channels over 8
# heads (head dims (160, 160): the split route at one query row), 2 classes
CLF_WIDTH = {**{k: v for k, v in MLM_WIDTH.items() if not k.startswith("decoder.")},
             "decoder.num_output_query_channels": 1280, "decoder.num_cross_attention_heads": 8}
CLF_FLAGS = [f"--model.{k}={v}" for k, v in CLF_WIDTH.items()]
CLF_ATTENDS = MLM_ATTENDS  # the encoder's cross attend, its 26 self-attends, the decoder's one query
# the classifier CLI's stages: phase 16's training flags, the peak at 1e-4
# (a decoder-only stage over a frozen random encoder moves little at 2e-5)
CLF_LR = 1e-4
# deepmind/vision-perceiver-fourier: 224 x 224 x 3, 64 bands, 512 x 1024
# latents, one cross head, 8 blocks x 6 shared self-attends of 8 heads, 1000
# classes, one decoder query of 1024 channels over one head
IMG_ENCODER = dict(image_shape=(224, 224, 3), num_frequency_bands=64, num_cross_attention_heads=1,
                   num_self_attention_heads=8, num_self_attention_layers_per_block=6, num_self_attention_blocks=8)
IMG_DECODER = dict(num_classes=1000, num_output_query_channels=1024, num_cross_attention_heads=1)
# parameters at these widths, as the JAX package counts them
# (tests/test_torch_port_{classifier,vision}.py); the image classifier's is
# the reference's (SURVEY.md section 4)
CLASSIFIER_PARAMS = {"text_classifier": 206_098_690, "text_classifier_cli_defaults": 95_801_090,
                     "image_classifier": 48_440_627}
IMG_ATTENDS = 50  # a forward: the cross attend (wide_mma), 48 self-attends (128, 128), the decoder's query (wide_mma)
IMG_WIDE = 2
IMG_TOP_K = 5
IMG_PIPE = 8  # uint8 images of 256 x 320 through ImageNetPreprocessor
# the image CLI at MNIST's shape (its defaults: 32 latents of 128 channels,
# 32 bands) with JAX's MNIST test's one cross head: q/k 131 on wide_mma; the
# self-attends' and the decoder's 8 heads of 16 take the plain path
MNIST_FLAGS = ["--model.encoder.num_cross_attention_heads=1", "--data=synthetic", "--data.batch_size=16",
               "--data.num_train=128", "--data.num_valid=32", "--data.num_test=32"]


def text_classifier_config(config_mod, common_mod, defaults: bool = False):
    """The text classifier at published width, or at the JAX CLI's defaults
    (256 latents of 1280 channels, the encoder's channels unset: 8 heads of
    160 in every attend)."""
    decoder = config_mod.ClassificationDecoderConfig(num_classes=2, num_output_query_channels=1280)
    if defaults:
        return config_mod.PerceiverIOConfig(common_mod.TextEncoderConfig(vocab_size=262, max_seq_len=MLM_SEQ),
                                            decoder, num_latents=256, num_latent_channels=1280)
    enc = {k.split(".", 1)[1]: v for k, v in CLF_WIDTH.items() if k.startswith("encoder.")}
    return config_mod.PerceiverIOConfig(
        common_mod.TextEncoderConfig(vocab_size=262, max_seq_len=MLM_SEQ, **enc), decoder,
        num_latents=CLF_WIDTH["num_latents"], num_latent_channels=CLF_WIDTH["num_latent_channels"])


def _forward_check(torch, flash, model, args, kwargs, want_routes: dict, tol_fp32: float,
                   phase: str = "classifiers", relative: bool = False) -> dict:
    """One forward of ``model`` with the kernels against ``attention_impl=
    "xla"`` on the same inputs: the error, K1's launches by route (gated
    equal to ``want_routes``) and finiteness. ``relative`` scales the fp32
    gate by the largest ``|output|``."""
    set_attention_impl(model, "auto")
    reset_counts(flash)
    with torch.no_grad():
        out = model(*args, **kwargs)
        torch.cuda.synchronize()
        routes = {r: n for r, n in flash.flash_attention.route_launches.items() if n}
        set_attention_impl(model, "xla")
        plain = model(*args, **kwargs)
    set_attention_impl(model, "auto")
    err = (out.float() - plain.float()).abs().max().item()
    biggest = plain.float().abs().max().item()
    tol = tol_fp32 * (biggest if relative else 1.0) if model.dtype == torch.float32 else 8 * bf16_ulp(biggest)
    finite = bool(torch.isfinite(out).all().item())
    line = dict(dtype=str(model.dtype).split(".")[-1], out_shape=list(out.shape), max_abs_err_vs_plain=err,
                tol=tol, out_max_abs=biggest, finite=finite, k1_launches=sum(routes.values()),
                k1_route_launches=routes)
    if not (err <= tol and finite) or routes != want_routes:
        emit(phase, **line)
        raise AssertionError(f"{phase} forward: max|d| {err} (tol {tol}), finite {finite}, "
                             f"K1 routes {routes} (want {want_routes})")
    return line


def _tile(dtype_name: str) -> str:
    return "wgmma" if dtype_name == "bfloat16" else "tf32x3"


def clf_forward(torch, flash, clf_mod, cfg, defaults_cfg) -> dict:
    """(a) the text classifier at published width, one forward of 4 rows at
    n = 2048 and at n = 1500 with right pads on two rows, fp32 and bf16,
    against ``xla``; K1 28 launches a forward (27 on the tile route of the
    type, the decoder's one query on split); then one forward at the JAX
    CLI's defaults, (160, 160) in every attend."""
    g = torch.Generator(device="cuda").manual_seed(17)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        tname = str(dtype).split(".")[-1]
        model = clf_mod.TextClassifier(cfg, dtype=dtype, seed=0).eval()
        params = sum(p.numel() for p in model.parameters())
        for n in (MLM_SEQ, MLM_RAGGED_N):
            x = torch.randint(0, 256, (4, n), generator=g, device="cuda")
            pad = torch.zeros(4, n, dtype=torch.bool, device="cuda")
            pad[1, n - 300:] = True
            pad[2, n // 2:] = True
            line = _forward_check(torch, flash, model, (x,), {"pad_mask": pad},
                                  {_tile(tname): CLF_ATTENDS - 1, "split": 1}, 1e-3)
            line.update(n=n, params=params)
            emit("classifiers", part="text_forward", **line)
            out[f"{tname}_{n}"] = line
        if dtype == torch.float32:
            out["model"] = model
        else:
            del model
        torch.cuda.empty_cache()
    layers = defaults_cfg.encoder.num_self_attention_layers_per_block * defaults_cfg.encoder.num_self_attention_blocks
    for dtype in (torch.float32, torch.bfloat16):
        tname = str(dtype).split(".")[-1]
        model = clf_mod.TextClassifier(defaults_cfg, dtype=dtype, seed=0).eval()
        x = torch.randint(0, 256, (4, MLM_SEQ), generator=g, device="cuda")
        pad = torch.zeros(4, MLM_SEQ, dtype=torch.bool, device="cuda")
        pad[3, 1000:] = True
        line = _forward_check(torch, flash, model, (x,), {"pad_mask": pad}, {_tile(tname): 1 + layers, "split": 1},
                              1e-3)
        line.update(n=MLM_SEQ, head_dims=[160, 160], params=sum(p.numel() for p in model.parameters()))
        emit("classifiers", part="text_forward_cli_defaults", **line)
        out[f"cli_defaults_{tname}"] = line
        del model
        torch.cuda.empty_cache()
    return out


def _clf_texts():
    """8 texts of 512-2048 bytes (``MLM_TEXT_LENS``): words over a few letters."""
    import numpy as np

    rng = np.random.default_rng(43)
    texts = []
    for n in MLM_TEXT_LENS:
        words = []
        while sum(len(w) + 1 for w in words) < n:
            words.append("".join(rng.choice(list("etaoinshrdlu"), size=int(rng.integers(2, 8)))))
        texts.append(" ".join(words)[:n])
    return texts


def clf_sentiment(torch, flash, pipelines_mod, preprocessor_cls, tokenizer_cls, model, smi: str) -> dict:
    """(b) ``pipeline("sentiment-analysis")`` over 8 byte texts of
    512-2048 bytes on the fp32 model: the labels equal the ``xla`` run's,
    but for a text whose own two class logits under ``xla`` lie within
    ``NEAR_TIE``; texts/s of the batch and the per-text latency p50."""
    import numpy as np

    texts = _clf_texts()
    prep = preprocessor_cls(tokenizer_cls(), max_seq_len=MLM_SEQ)
    pipe = pipelines_mod.pipeline("sentiment-analysis", model, prep)
    pipe(texts[:1])  # warm-up
    reset_counts(flash)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    labels = pipe(texts)
    batch_s = time.perf_counter() - t0
    routes = {r: n for r, n in flash.flash_attention.route_launches.items() if n}
    latency = []
    for text in texts:
        t1 = time.perf_counter()
        pipe(text)
        latency.append((time.perf_counter() - t1) * 1e3)
    ids, pad = (torch.as_tensor(np.asarray(x), device="cuda") for x in prep.preprocess_batch(texts))
    set_attention_impl(model, "xla")
    try:
        with torch.no_grad():
            xla_logits = model(ids.long(), pad_mask=pad).float().cpu().numpy()
        xla_labels = pipe(texts)
    finally:
        set_attention_impl(model, "auto")
    gaps = np.abs(xla_logits[:, 0] - xla_logits[:, 1])
    differing = [i for i, (a, b) in enumerate(zip(labels, xla_labels)) if a["label"] != b["label"]]
    unexcused = [i for i in differing if gaps[i] >= NEAR_TIE]
    line = dict(part="sentiment_analysis", card=smi, texts=len(texts), text_bytes=list(MLM_TEXT_LENS),
                batch_s=batch_s, texts_per_s=len(texts) / batch_s, latency_ms=latency,
                latency_ms_p50=float(np.median(latency)), k1_launches=sum(routes.values()),
                k1_route_launches=routes, labels=[r["label"] for r in labels],
                scores=[r["score"] for r in labels], xla_labels=[r["label"] for r in xla_labels],
                xla_logit_gaps=gaps.tolist(), differing_texts=differing, unexcused=unexcused)
    emit("classifiers", **line)
    if unexcused or routes != {"tf32x3": CLF_ATTENDS - 1, "split": 1}:
        raise AssertionError(f"sentiment-analysis: texts {unexcused} differ from the xla run's past a near tie, "
                             f"K1 routes {routes}")
    return line


def _steps_ms(root: Path) -> list:
    """The trainer's logged step times (``train/steps_per_sec``, host clock)."""
    rows = [json.loads(line) for line in open(root / "metrics.jsonl")]
    return [1e3 / r["train/steps_per_sec"] for r in rows if r.get("train/steps_per_sec")]


def _cli_stage(torch, flash, ragged, training, main, argv, root: Path) -> tuple:
    """One CLI ``fit`` through :func:`cli_run` with the peak memory and the
    logged losses and step times beside its record."""
    import gc

    import numpy as np

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state, rec = cli_run(torch, flash, ragged, main, [*argv, f"--trainer.default_root_dir={root}"], training)
    losses, val_loss = _cli_losses(root)
    steps_ms = _steps_ms(root)
    rec.update(losses=losses, val_loss=val_loss, max_memory_allocated=torch.cuda.max_memory_allocated(),
               step_ms=steps_ms, step_ms_p50=float(np.median(steps_ms[1:] or steps_ms)),
               launches_per_step={k: rec["launches"][k] / TRAIN_STEPS for k in ("k1", "k2", "k3")})
    return state, rec


def clf_cli(torch, flash, ragged, training, mlm_mod, clf_script, mlm_cfg, root: Path, smi: str) -> dict:
    """(c) the classifier CLI's two-stage ``fit`` in bf16 at published
    width over the synthetic corpus's classification task: a masked LM of
    the same widths saved by the port; stage 1 warm-starts the encoder from
    it (``--model.encoder.params``) and freezes it, stage 2 starts from
    stage 1's checkpoint unfrozen; then ``validate`` / ``test --ckpt``."""
    import dataclasses
    import gc

    from perceiver_io_tpu_torch.scripts.cli import CLI

    # the family in bf16 (its own default is JAX's fp32)
    main = CLI(dataclasses.replace(
        clf_script.FAMILY,
        build_model=lambda cfg, dm, **kw: clf_script.TextClassifier(cfg, dtype=torch.bfloat16, **kw))).main
    mlm_dir = root / "mlm"
    mlm = mlm_mod.MaskedLanguageModel(mlm_cfg, seed=11)
    training.save_pretrained(str(mlm_dir), mlm, mlm_cfg)
    del mlm
    data_kw = dict(dataset_dir=str(root / "data"), max_seq_len=MLM_SEQ, batch_size=8, num_train_docs=64,
                   num_valid_docs=8, doc_chars=2800, task="clf")
    common = [*[f"--data.{k}={v}" for k, v in data_kw.items()], "--data=synthetic", *CLF_FLAGS, *CLI_TRAIN,
              f"--optimizer.lr={CLF_LR}"]
    attends = 2 * CLF_ATTENDS
    k1_routes, bwd_routes = {"wgmma": attends - 2, "split": 2}, {"wgmma": attends}
    runs = {}
    stage1 = root / "stage1"
    state, runs["frozen"] = _cli_stage(torch, flash, ragged, training, main,
                                       ["fit", *common, f"--model.encoder.params={mlm_dir}",
                                        "--model.encoder.freeze=true"], stage1)
    loaded = training.load_subtree(str(mlm_dir), "encoder")
    encoder = {k: v.cpu() for k, v in state.model.encoder.state_dict().items()}
    trained = {id(p) for group in state.optimizer.param_groups for p in group["params"]}
    runs["frozen"].update(
        encoder_bit_identical=sorted(loaded) == sorted(encoder) and all(torch.equal(loaded[k], encoder[k])
                                                                         for k in loaded),
        optimizer_params=sum(p.numel() for p in state.model.parameters() if id(p) in trained),
        model_params=sum(p.numel() for p in state.model.parameters()),
        # the encoder's backward runs (K2/K3 at every attend, the encoder's 27
        # included), as under JAX's masked optimizer, which zeroes the
        # updates of gradients it computed
        encoder_gradients_computed=runs["frozen"]["launches_per_step"]["k3"] == attends)
    del state, encoder
    gc.collect()
    stage2 = root / "stage2"
    state, runs["unfrozen"] = _cli_stage(torch, flash, ragged, training, main,
                                         ["fit", *common, f"--params={stage1 / 'checkpoints'}",
                                          "--model.encoder.freeze=false"], stage2)
    after = {k: v.cpu() for k, v in state.model.encoder.state_dict().items()}
    stage1_encoder = training.load_subtree(str(stage1 / "checkpoints"), "encoder")
    runs["unfrozen"]["encoder_trained"] = any(not torch.equal(stage1_encoder[k], after[k]) for k in after)
    del state, after
    failures = []
    for stage, rec in runs.items():
        failures += [f"{stage}: {f}" for f in _fit_failures(rec, TRAIN_STEPS, attends, k1_routes, bwd_routes)]
        if not (len(rec["losses"]) == TRAIN_STEPS and all(math.isfinite(x) for x in rec["losses"])):
            failures.append(f"{stage}: losses {rec['losses']}")
        emit("classifiers", part=f"cli_fit_{stage}", card=smi, steps=TRAIN_STEPS,
             **{k: v for k, v in rec.items() if k != "k4_routes"})
    if not runs["frozen"]["losses"][-1] < runs["frozen"]["losses"][0]:
        failures.append(f"frozen: the loss did not fall: {runs['frozen']['losses']}")
    if not runs["frozen"]["encoder_bit_identical"]:
        failures.append("frozen: the encoder moved from the loaded masked LM's")
    if not runs["unfrozen"]["encoder_trained"]:
        failures.append("unfrozen: the encoder did not move")
    for sub in ("validate", "test"):
        metrics, runs[sub] = cli_run(torch, flash, ragged, main,
                                     [sub, *common, f"--ckpt={stage2 / 'checkpoints'}",
                                      f"--trainer.default_root_dir={root / sub}"])
        keys = ("loss", "accuracy") if sub == "validate" else ("test_loss", "test_accuracy")
        emit("classifiers", part=f"cli_{sub}", card=smi, metrics=metrics, wall_s=runs[sub]["wall_s"],
             k1_launches=runs[sub]["launches"]["k1"], k1_routes=runs[sub]["k1_routes"])
        if sorted(metrics) != sorted(keys) or not all(math.isfinite(metrics[k]) for k in keys) \
                or runs[sub]["k1_routes"]["wgmma"] != CLF_ATTENDS - 1 or runs[sub]["k1_routes"]["split"] != 1:
            failures.append(f"{sub}: {metrics}, K1 routes {runs[sub]['k1_routes']}")
        if sub == "validate" and not math.isclose(metrics["loss"], runs["unfrozen"]["val_loss"][-1], rel_tol=1e-5):
            failures.append(f"validate's loss {metrics['loss']} is not stage 2's validation loss "
                            f"{runs['unfrozen']['val_loss'][-1]}")
        gc.collect()
        torch.cuda.empty_cache()
    if failures:
        raise AssertionError("classifier cli: " + "; ".join(failures))
    runs["config"] = dataclasses.asdict(training.load_config(str(stage2 / "checkpoints")))
    return runs


def image_classifier_config(config_mod, vision_mod):
    return config_mod.PerceiverIOConfig(vision_mod.ImageEncoderConfig(**IMG_ENCODER),
                                        config_mod.ClassificationDecoderConfig(**IMG_DECODER),
                                        num_latents=512, num_latent_channels=1024)


def img_forward(torch, flash, vision_mod, cfg) -> dict:
    """(d) the image classifier at 224 x 224, one forward at b = 4, fp32 and
    bf16, against ``xla``: K1 50 launches a forward, the encoder's cross
    attend and the decoder's query on wide_mma, the 48 self-attends on the
    tile route of the type."""
    g = torch.Generator(device="cuda").manual_seed(19)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        tname = str(dtype).split(".")[-1]
        model = vision_mod.ImageClassifier(cfg, dtype=dtype, seed=0).eval()
        x = torch.randn(4, *IMG_ENCODER["image_shape"], generator=g, device="cuda")
        line = _forward_check(torch, flash, model, (x,), {},
                              {K1_WIDE_ROUTE: IMG_WIDE, _tile(tname): IMG_ATTENDS - IMG_WIDE}, 1e-3)
        line.update(b=4, params=sum(p.numel() for p in model.parameters()))
        emit("classifiers", part="image_forward", **line)
        out[tname] = line
        if dtype == torch.float32:
            out["model"] = model
        else:
            del model
        torch.cuda.empty_cache()
    return out


def img_pipeline(torch, flash, pipelines_mod, data_vision, model, smi: str) -> dict:
    """(d) ``pipeline("image-classification")`` top-5 over 8 seeded uint8
    images of 256 x 320 through ``ImageNetPreprocessor`` on the fp32 model:
    top-1 equals the ``xla`` run's but for an image whose own top-2 ``xla``
    logits lie within ``NEAR_TIE``; images/s and the per-image latency p50."""
    import numpy as np

    rng = np.random.default_rng(23)
    images = rng.integers(0, 256, (IMG_PIPE, 256, 320, 3), dtype=np.uint8)
    prep = data_vision.ImageNetPreprocessor(crop=IMG_ENCODER["image_shape"][0])  # 256 shorter side, 224 crop
    pipe = pipelines_mod.pipeline("image-classification", model, prep)
    pipe(images[:1], top_k=IMG_TOP_K)  # warm-up
    reset_counts(flash)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    top = pipe(images, top_k=IMG_TOP_K)
    batch_s = time.perf_counter() - t0
    routes = {r: n for r, n in flash.flash_attention.route_launches.items() if n}
    latency = []
    for img in images:
        t1 = time.perf_counter()
        pipe(img, top_k=IMG_TOP_K)
        latency.append((time.perf_counter() - t1) * 1e3)
    set_attention_impl(model, "xla")
    try:
        with torch.no_grad():
            xla_logits = model(torch.as_tensor(prep(images), device="cuda")).float().cpu().numpy()
    finally:
        set_attention_impl(model, "auto")
    order = np.argsort(-xla_logits, axis=-1)
    gap = np.take_along_axis(xla_logits, order[:, :1], -1)[:, 0] - np.take_along_axis(xla_logits, order[:, 1:2], -1)[:, 0]
    differing = [i for i, row in enumerate(top) if row[0]["label"] != int(order[i, 0])]
    unexcused = [i for i in differing if gap[i] >= NEAR_TIE]
    line = dict(part="image_classification", card=smi, images=IMG_PIPE, image_hw=[256, 320], top_k=IMG_TOP_K,
                batch_s=batch_s, images_per_s=IMG_PIPE / batch_s, latency_ms=latency,
                latency_ms_p50=float(np.median(latency)), k1_launches=sum(routes.values()),
                k1_route_launches=routes, top1=[row[0]["label"] for row in top],
                xla_top1=order[:, 0].tolist(), xla_top2_gaps=gap.tolist(), differing_images=differing,
                unexcused=unexcused, top_k_each=all(len(row) == IMG_TOP_K for row in top))
    emit("classifiers", **line)
    if unexcused or not line["top_k_each"] or routes != {K1_WIDE_ROUTE: IMG_WIDE, "tf32x3": IMG_ATTENDS - IMG_WIDE}:
        raise AssertionError(f"image-classification: images {unexcused} differ from the xla run's top-1 past "
                             f"a near tie, top-k each {line['top_k_each']}, K1 routes {routes}")
    return line


def img_fit(torch, flash, training, parallel, vision_mod, cfg, root: Path) -> dict:
    """(d) a bf16 ``Trainer.fit`` of the image classifier through phase 13's
    ``train_fit``: 8 steps of 8 synthetic 224 x 224 x 3 images in 2
    microbatches (two seeded batches cycled), K1, K2 and K3 100 launches a
    step, 4 of them at the wide pairs (the cross attend and the decoder's
    query): K1, K2 and K3 on ``wide_mma``."""
    import numpy as np

    rng = np.random.default_rng(29)
    batches = [{"image": rng.standard_normal((8, *IMG_ENCODER["image_shape"])).astype(np.float32),
                "label": rng.integers(0, IMG_DECODER["num_classes"], 8)} for _ in range(2)]
    return train_fit(torch, flash, training, parallel, vision_mod.ImageClassifier, cfg, torch.bfloat16, root,
                     batches, batches, batches[:1], lr=1e-4, warmup_steps=2, phase="classifiers_image_fit",
                     make_loss=lambda model, cfg: training.image_classifier_loss_fn(model),
                     attends=2 * IMG_ATTENDS, tokens_per_step=8, wide=2 * IMG_WIDE)


def mnist_cli(torch, flash, ragged, training, img_script, root: Path, smi: str) -> dict:
    """(e) the image CLI at MNIST's shape (fp32, the family's) over the
    synthetic image data module, JAX's MNIST test's one cross head:
    ``fit`` (8 steps of 16 in 2 microbatches, AdamW to 1e-3), its cross
    attend (131, 131) on ``wide_mma`` in K1, K2 and K3, then ``validate`` /
    ``test --ckpt``. Eight steps hardly move this model's loss (a CPU run of
    the same flags logs the card's curve, 2.30 -> 2.27-2.30), so the gates
    are finite losses and ``validate`` reproducing the fit's own validation
    loss from its checkpoint."""
    import dataclasses

    common = [*MNIST_FLAGS, *CLI_TRAIN, "--optimizer.lr=1e-3"]
    runs = {}
    state, runs["fit"] = _cli_stage(torch, flash, ragged, training, img_script.main, ["fit", *common], root / "fit")
    failures = _fit_failures(runs["fit"], TRAIN_STEPS, 2, {K1_WIDE_ROUTE: 2}, {K23_WIDE_ROUTE: 2})
    losses = runs["fit"]["losses"]
    if not (len(losses) == TRAIN_STEPS and all(math.isfinite(x) for x in losses)):
        failures.append(f"losses {losses}")
    runs["config"] = dataclasses.asdict(state.model.config)
    del state
    emit("classifiers", part="mnist_cli_fit", card=smi, steps=TRAIN_STEPS,
         **{k: v for k, v in runs["fit"].items() if k != "k4_routes"})
    for sub in ("validate", "test"):
        metrics, runs[sub] = cli_run(torch, flash, ragged, img_script.main,
                                     [sub, *common, f"--ckpt={root / 'fit' / 'checkpoints'}",
                                      f"--trainer.default_root_dir={root / sub}"])
        emit("classifiers", part=f"mnist_cli_{sub}", card=smi, metrics=metrics, k1_routes=runs[sub]["k1_routes"])
        if not all(math.isfinite(v) for v in metrics.values()) or runs[sub]["k1_routes"][K1_WIDE_ROUTE] != 1 \
                or runs[sub]["launches"]["k1"] != 1:
            failures.append(f"{sub}: {metrics}, K1 routes {runs[sub]['k1_routes']}")
        runs[sub]["metrics"] = metrics
    fit_val, val = runs["fit"]["val_loss"][-1], runs["validate"]["metrics"]["loss"]
    if not math.isclose(val, fit_val, rel_tol=1e-5):
        failures.append(f"validate's loss {val} is not the fit's validation loss {fit_val}")
    if failures:
        raise AssertionError("mnist cli: " + "; ".join(failures))
    return runs


def classifiers_phase(torch, flash, ragged, pipelines_mod, training, parallel, root: Path, smi: str) -> dict:
    """Phase 18: the text classifier at language-perceiver width ((a) the
    forward against ``xla``, also at the JAX CLI's defaults, (b)
    ``sentiment-analysis``, (c) the CLI's two-stage ``fit`` and
    ``validate`` / ``test``) and the Fourier image classifier at
    deepmind/vision-perceiver-fourier width ((d) the forward, the
    ``image-classification`` pipeline and a bf16 fit) and at MNIST's shape
    ((e) the image CLI)."""
    import gc

    from perceiver_io_tpu_torch.data import text as data_text
    from perceiver_io_tpu_torch.data import vision as data_vision
    from perceiver_io_tpu_torch.data.text.tokenizers import ByteTokenizer
    from perceiver_io_tpu_torch.models import vision as vision_mod
    from perceiver_io_tpu_torch.models.core import config as config_mod
    from perceiver_io_tpu_torch.models.text import classifier as clf_mod
    from perceiver_io_tpu_torch.models.text import common as common_mod
    from perceiver_io_tpu_torch.models.text import mlm as mlm_mod
    from perceiver_io_tpu_torch.scripts.text import classifier as clf_script
    from perceiver_io_tpu_torch.scripts.vision import image_classifier as img_script

    t_phase = time.perf_counter()
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    seconds = {}

    def lap(name):
        seconds[name] = time.perf_counter() - t_phase - sum(seconds.values())

    cfg = text_classifier_config(config_mod, common_mod)
    forward = clf_forward(torch, flash, clf_mod, cfg, text_classifier_config(config_mod, common_mod, defaults=True))
    model = forward.pop("model")
    sentiment = clf_sentiment(torch, flash, pipelines_mod, data_text.TextPreprocessor, ByteTokenizer, model, smi)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    lap("text_forward_and_pipeline")
    cli = clf_cli(torch, flash, ragged, training, mlm_mod, clf_script,
                  language_perceiver_config(config_mod, common_mod, mlm_mod), root / "text_cli", smi)
    lap("text_cli")
    img_cfg = image_classifier_config(config_mod, vision_mod)
    image = img_forward(torch, flash, vision_mod, img_cfg)
    model = image.pop("model")
    pipe = img_pipeline(torch, flash, pipelines_mod, data_vision, model, smi)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    fit = img_fit(torch, flash, training, parallel, vision_mod, img_cfg, root / "image_fit")
    lap("image")
    mnist = mnist_cli(torch, flash, ragged, training, img_script, root / "mnist_cli", smi)
    lap("mnist_cli")
    total = time.perf_counter() - t_phase
    params = {"text_classifier": forward[f"float32_{MLM_SEQ}"]["params"],
              "text_classifier_cli_defaults": forward["cli_defaults_float32"]["params"],
              "image_classifier": image["float32"]["params"]}
    emit("classifiers", part="done", card=smi, seconds=total, seconds_by_part=seconds, params=params,
         reference_params=CLASSIFIER_PARAMS)
    if params != CLASSIFIER_PARAMS:
        raise AssertionError(f"parameter counts {params}, the JAX package's {CLASSIFIER_PARAMS}")
    return {"forward": forward, "sentiment": sentiment, "cli": cli, "image": image, "image_pipeline": pipe,
            "image_fit": fit, "mnist_cli": mnist, "params": params, "seconds": total, "seconds_by_part": seconds}


# deepmind/optical-flow-perceiver as its transformers config holds it (the
# port's hf_import.optical_flow_config_from_hf reads it): 368 x 496 patches
# of 27 pixel-patch channels a frame, 64 hidden channels + 64 Fourier bands
# (d_model 322), 2048 x 512 latents, 24 self-attends of 16 heads (32 each),
# one cross head at (322, 322), the decoder's one head at (512, 512)
# without an attention residual, widening 1 / 1
FLOW_HF = dict(train_size=[368, 496], d_model=322, d_latents=512, num_latents=2048, num_blocks=1,
               num_self_attends_per_block=24, num_self_attention_heads=16, num_cross_attention_heads=1,
               qk_channels=None, v_channels=None, cross_attention_widening_factor=1,
               self_attention_widening_factor=1, attention_probs_dropout_prob=0.0, initializer_range=0.02,
               hidden_act="gelu")
FLOW_PARAMS = 41_057_134  # both packages at this width (tests/test_torch_port_flow.py)
FLOW_ATTENDS = 26  # a forward: the encoder's cross attend, 24 self-attends, the decoder's cross attend
FLOW_WIDE = 2  # the two cross attends: (322, 322) and (512, 512), outside HEAD_DIMS
FLOW_BATCH = 2
FLOW_TIMED = 5  # timed forwards per type
FLOW_PAIR_HW = (436, 1024)  # Sintel's frames: 6 patches of 368 x 496 a pair
FLOW_OVERLAP = 20  # the patches' least overlap (the processor's default)
FLOW_PAIRS = 2
FLOW_PIPE_BATCH = 2


def flow_config():
    import types

    from perceiver_io_tpu_torch.convert import hf_import

    return hf_import.optical_flow_config_from_hf(types.SimpleNamespace(**FLOW_HF))


def flow_forward(torch, flash, flow_mod, cfg) -> dict:
    """(a)-(c): one forward of ``FLOW_BATCH`` synthetic frame pairs
    (seeded numpy features, ``(2, 2, 27, 368, 496)``) in fp32 and bf16
    against ``xla`` (fp32 at 1e-3 as the classifiers but of the largest
    |flow|, which random weights keep near 1e-3; bf16 at 8 ulps of it), K1
    26 launches a forward (the two cross attends on
    ``wide_mma``, the 24 self-attends on the tile route of the type); then
    ``FLOW_TIMED`` timed forwards: ms, images/s and the peak allocation."""
    import numpy as np

    rng = np.random.default_rng(31)
    x = torch.from_numpy(rng.standard_normal((FLOW_BATCH, 2, 27, *cfg.encoder.image_shape)).astype(np.float32))
    x = x.to("cuda")
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        tname = str(dtype).split(".")[-1]
        model = flow_mod.OpticalFlow(cfg, dtype=dtype, seed=0).eval()
        line = _forward_check(torch, flash, model, (x,), {},
                              {K1_WIDE_ROUTE: FLOW_WIDE, _tile(tname): FLOW_ATTENDS - FLOW_WIDE}, 1e-3, phase="flow",
                              relative=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = []
        with torch.no_grad():
            for _ in range(FLOW_TIMED):
                t0 = time.perf_counter()
                model(x)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
        p50 = float(np.median(ms))
        line.update(b=FLOW_BATCH, params=sum(p.numel() for p in model.parameters()), forward_ms=ms,
                    forward_ms_p50=p50, images_per_s=FLOW_BATCH / (p50 / 1e3),
                    peak_memory_bytes=torch.cuda.max_memory_allocated())
        emit("flow", part="forward", **line)
        out[tname] = line
        if dtype == torch.float32:
            out["model"] = model
        else:
            del model
        torch.cuda.empty_cache()
    return out


def flow_pipeline(torch, flash, pipelines_mod, data_vision, model, smi: str) -> dict:
    """(d)-(e): ``pipeline("optical-flow")`` over ``FLOW_PAIRS`` seeded uint8
    frame pairs of Sintel's 436 x 1024 on the fp32 model, micro-batches of
    ``FLOW_PIPE_BATCH`` patches (6 patches a pair): pairs/s, the per-pair
    latency p50, K1 26 launches a micro-batch; its flow equals the same
    model's run patch by patch (b = 1) through ``OpticalFlowProcessor`` at
    fp32 1e-5; then once with ``render=True`` (uint8 RGB of the frames'
    shape)."""
    import numpy as np

    rng = np.random.default_rng(37)
    pairs = [tuple(rng.integers(0, 256, (*FLOW_PAIR_HW, 3), dtype=np.uint8) for _ in range(2))
             for _ in range(FLOW_PAIRS)]
    patch = tuple(model.config.encoder.image_shape)
    kw = dict(patch_size=patch, patch_min_overlap=FLOW_OVERLAP, batch_size=FLOW_PIPE_BATCH)
    pipe = pipelines_mod.pipeline("optical-flow", model, **kw)
    pipe(pairs[0])  # warm-up
    reset_counts(flash)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = pipe(pairs)
    batch_s = time.perf_counter() - t0
    routes = {r: n for r, n in flash.flash_attention.route_launches.items() if n}
    latency = []
    for pair in pairs:
        t1 = time.perf_counter()
        pipe(pair)
        latency.append((time.perf_counter() - t1) * 1e3)
    proc = data_vision.OpticalFlowProcessor(patch_size=patch, patch_min_overlap=FLOW_OVERLAP)
    patches = len(proc.grid_indices(FLOW_PAIR_HW))
    calls = -(-FLOW_PAIRS * patches // FLOW_PIPE_BATCH)

    def one_by_one(x):
        with torch.no_grad():
            return np.concatenate([model(torch.as_tensor(p[None], device="cuda")).float().cpu().numpy() for p in x])

    want = proc.process(one_by_one, pairs, batch_size=1)
    err = float(np.abs(got - want).max())
    close = bool(np.allclose(got, want, atol=1e-5, rtol=1e-5))
    rendered = pipelines_mod.pipeline("optical-flow", model, render=True, **kw)(pairs)
    render_ok = rendered.shape == (FLOW_PAIRS, *FLOW_PAIR_HW, 3) and rendered.dtype == np.uint8
    want_routes = {K1_WIDE_ROUTE: FLOW_WIDE * calls, "tf32x3": (FLOW_ATTENDS - FLOW_WIDE) * calls}
    line = dict(part="pipeline", card=smi, pairs=FLOW_PAIRS, frame_hw=list(FLOW_PAIR_HW), patches_per_pair=patches,
                batch_size=FLOW_PIPE_BATCH, forwards=calls, batch_s=batch_s, pairs_per_s=FLOW_PAIRS / batch_s,
                latency_ms=latency, latency_ms_p50=float(np.median(latency)), flow_shape=list(got.shape),
                finite=bool(np.isfinite(got).all()), flow_max_abs=float(np.abs(got).max()),
                max_abs_err_vs_patch_by_patch=err, within_1e5=close, k1_launches=sum(routes.values()),
                k1_route_launches=routes, rendered_shape=list(rendered.shape), rendered_dtype=str(rendered.dtype),
                rendered_equals_flow=bool(np.array_equal(rendered, np.stack(
                    [data_vision.render_optical_flow(f) for f in got]))))
    emit("flow", **line)
    if not (close and line["finite"] and render_ok and routes == want_routes
            and got.shape == (FLOW_PAIRS, *FLOW_PAIR_HW, 2)):
        raise AssertionError(f"optical-flow pipeline: max|d| {err} against the patch-by-patch run (1e-5: {close}), "
                             f"finite {line['finite']}, rendered {rendered.shape} {rendered.dtype}, K1 routes "
                             f"{routes} (want {want_routes})")
    return line


def flow_phase(torch, flash, pipelines_mod, smi: str) -> dict:
    """Phase 19: optical flow at deepmind/optical-flow-perceiver width
    (``FLOW_HF`` through the port's ``optical_flow_config_from_hf``; random
    weights from a seed): (a)-(c) the forward against ``xla`` with its
    launches, times and peak memory, (d)-(e) the ``optical-flow``
    pipeline."""
    import gc

    from perceiver_io_tpu_torch.data import vision as data_vision
    from perceiver_io_tpu_torch.models.vision import optical_flow as flow_mod

    t_phase = time.perf_counter()
    cfg = flow_config()
    forward = flow_forward(torch, flash, flow_mod, cfg)
    model = forward.pop("model")
    pipe = flow_pipeline(torch, flash, pipelines_mod, data_vision, model, smi)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    params = forward["float32"]["params"]
    emit("flow", part="done", card=smi, seconds=time.perf_counter() - t_phase, params=params,
         reference_params=FLOW_PARAMS)
    if params != FLOW_PARAMS:
        raise AssertionError(f"optical flow: {params} parameters, the JAX package's {FLOW_PARAMS}")
    return {"forward": forward, "pipeline": pipe, "params": params}


K1_SOURCES = {
    "split": "perceiver_io_tpu_torch/csrc/flash_attention_fwd_split.cu",
    "wgmma": "perceiver_io_tpu_torch/csrc/flash_attention_fwd_wgmma.cu",
    "tf32x3": "perceiver_io_tpu_torch/csrc/flash_attention_fwd_tf32.cu",
    "wide_mma": "perceiver_io_tpu_torch/csrc/flash_attention_fwd_wide_mma.cu",
    "wide": "perceiver_io_tpu_torch/csrc/flash_attention_fwd_wide.cu",
}
K1_LAUNCHES_FROM = {"split": "the bucket serve run (fp32 decode attends)",
                    "tf32x3": "the bucket serve run (fp32 prefill)",
                    "wgmma": "the bf16 Trainer.fit run (8 steps and its validation pass)"}


def sam_figures(case: dict, keys) -> dict:
    """A GiantMIDI (d = 96) case's numbers for a summary entry."""
    return {"case": f"{case['case']} d={case['d']}", **{k: case[k] for k in keys if k in case}}


def k1_route_entry(flash, design: str, main: tuple, cases: list, launches: int,
                   symbolic_launches: dict) -> dict:
    """The summary line's entry for one of K1's routes: its main case's
    numbers, its GiantMIDI case's at d = 96 (``d96``) and every case that
    took it. ``launches`` counts the route's calls; ``kernel_launches`` the
    device kernels they launched; ``symbolic_launches`` its calls in each
    run of the symbolic phase."""
    mine = [c for c in cases if c["route"] == design]
    head = next(c for c in mine if (c["case"], c["dtype"], c["d"]) == (*main, K1_HEAD_DIM))
    sam = next(c for c in mine if (c["case"], c["dtype"]) == (main[0] + "_sam", main[1]))
    keys = ("ms", "prev_ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "library_backend")
    if design == "tf32x3":
        keys += ("bound_simt_ms", "bound_simt_by")
    return {
        "name": f"flash_attention_fwd[{design}]", "route": "cuda", "design": design,
        "head_dims": sorted({(c["d"], c["dv"]) for c in mine}), "instantiated_head_dims": flash.HEAD_DIMS,
        "source": K1_SOURCES[design], "replaces": "perceiver_io_tpu/ops/flash_attention.py:198",
        "launches": launches, "kernel_launches": launches * flash.ROUTE_KERNELS[design],
        "launches_from": K1_LAUNCHES_FROM[design],
        "max_abs_err": max(c["max_abs_err"] for c in mine), "case": f"{main[0]} {main[1]} d={K1_HEAD_DIM}",
        **{k: head[k] for k in keys}, "prev_route": "simt",
        "d96": sam_figures(sam, keys + ("max_abs_err",)), "symbolic_launches": symbolic_launches,
        "cases": [{"case": c["case"], "dtype": c["dtype"], "d": c["d"], "dv": c["dv"], "causal": c["causal"],
                   **{k: c[k] for k in keys if not k.endswith("_by")}} for c in mine],
    }


K4_SOURCES = {"split": "perceiver_io_tpu_torch/csrc/ragged_paged_attention_split.cu",
              "tc": "perceiver_io_tpu_torch/csrc/ragged_paged_attention_tc.cu"}
K4_REPLACES = "perceiver_io_tpu/ops/ragged_attention.py:156"


def k4_route_entry(ragged, design: str, main: tuple, cases: list, launches: int,
                   prefix_launches: int, preempt_launches: dict, symbolic_launches: dict) -> dict:
    """The summary line's entry for one of K4's routes: its main case's
    numbers (fp32, d = 112) and every case that took it. ``launches``
    counts the route's calls in the paged slot-serve run,
    ``slot_prefix_launches`` in the paged slot-prefix run (chunked, prefix
    sharing on) and ``slot_preempt_launches`` in each slot-preempt run;
    ``kernel_launches`` the device kernels of the first."""
    mine = [c for c in cases if c["route"] == design]
    head = next(c for c in mine if (c["case"], c["layout"], c["d"]) == (*main, K1_HEAD_DIM))
    sam = next(c for c in mine if (c["case"], c["layout"]) == (main[0] + "_sam", main[1]))
    keys = ("ms", "prev_ms", "plain_ms", "bound_ms", "bound_by", "gather_sdpa_ms")
    if design == "tc":
        keys += ("bound_simt_ms", "bound_simt_by")
    return {
        "name": f"ragged_paged_attention[{design}]", "route": "cuda", "design": design,
        "source": K4_SOURCES[design], "replaces": K4_REPLACES, "launches": launches,
        "kernel_launches": launches * ragged.ROUTE_KERNELS[design],
        "slot_prefix_launches": prefix_launches, "slot_preempt_launches": preempt_launches,
        "launches_from": "the paged slot-serve run (fp32)",
        "max_abs_err": max(c["max_abs_err"] for c in mine if c["layout"] != "bfloat16"),
        "max_abs_err_bf16": max(c["max_abs_err"] for c in mine if c["layout"] == "bfloat16"),
        "case": f"{main[0]} {main[1]} d={K1_HEAD_DIM}", **{k: head[k] for k in keys},
        "library_ms": None, "prev_route": "simt",
        "d96": sam_figures(sam, keys + ("max_abs_err",)), "symbolic_launches": symbolic_launches,
        "cases": [{"case": c["case"], "layout": c["layout"], "d": c["d"], "h": c["h"],
                   **{k: c[k] for k in keys if not k.endswith("_by")}, "max_abs_err": c["max_abs_err"]}
                  for c in mine],
    }


K23_SOURCES = {"wgmma": "perceiver_io_tpu_torch/csrc/flash_attention_bwd_wgmma.cu",
               "tf32x3": "perceiver_io_tpu_torch/csrc/flash_attention_bwd_tf32.cu",
               "wide_mma": "perceiver_io_tpu_torch/csrc/flash_attention_bwd_wide_mma.cu",
               "wide": "perceiver_io_tpu_torch/csrc/flash_attention_bwd_wide.cu"}
#: per K23 kernel: (wrapper name, TPU function, counter key, gradients)
K23_KERNELS = {
    "dq": ("flash_attention_bwd_dq", "perceiver_io_tpu/ops/flash_attention.py:290", "k2", ("dq",)),
    "dkv": ("flash_attention_bwd_dkv", "perceiver_io_tpu/ops/flash_attention.py:367", "k3", ("dk", "dv")),
}


def k23_entries(kname: str, fits: dict, cases: list, resilience: dict, symbolic: dict, cli: dict,
                mlm: dict, clf_bwd: dict) -> list:
    """The summary line's entries for K2 (``dq``) or K3 (``dkv``), one per
    route the main path runs (``wgmma`` in bf16, ``tf32x3`` in fp32): the
    cross case (i = 512, j = 768, d = 112) of its type at the top, launches
    from the Trainer.fit run of its type, the train_resilience runs' of that
    type, the cli phase's fits' (bf16: their route's; fp32: none), the mlm
    phase's fits' (``mlm_launches``, bf16), the classifiers phase's runs'
    (``classifiers_launches``, from ``clf_bwd``: each run's launches by
    route), the (d, dv) pairs its cases ran and every case that took it."""
    from perceiver_io_tpu_torch.ops.flash_attention import HEAD_DIMS

    name, replaces, count, grads = K23_KERNELS[kname]
    entries = []
    for tname, design in (("bfloat16", K23_ROUTE["bfloat16"]), ("float32", K23_ROUTE["float32"])):
        keys = ("ms", "prev_ms", "plain_ms", "bound_ms", "bound_by")
        if design == "tf32x3":
            keys += ("bound_simt_ms", "bound_simt_by")
        mine = [c for c in cases if c["dtype"] == tname and c["expected_route"] == design]
        head = next(c for c in mine if c["case"] == "cross" and c["j"] == 768)
        sam = next(c for c in mine if c["case"] == "cross_sam")
        entries.append({
            "name": f"{name}[{design}]", "route": "cuda", "design": design, "source": K23_SOURCES[design],
            "replaces": replaces, "launches": fits[tname]["bwd_route_launches"][count][design],
            "launches_from": f"the {tname} Trainer.fit run (8 steps)",
            "train_resilience_launches": {run: v[count] for run, v in resilience.items()
                                          if ("bfloat16" in run) == (tname == "bfloat16")},
            "max_abs_err": max(c["max_abs_err"][g] for c in mine for g in grads),
            **{k: head["kernels"][kname][k] for k in keys},
            "library_ms": head["library_ms"], "library_backend": head["library_backend"],
            "library_note": "backward of scaled_dot_product_attention (memory-efficient backend), "
                            "dq, dk and dv together",
            "shape": f"cross-attention b=4 h=8 i=512 j=768 d=112 {tname}, causal, left pads",
            "prev_route": "simt",
            "d96": {"case": f"cross_sam i={sam['i']} j={sam['j']} d=96",
                    **{k: sam["kernels"][kname][k] for k in keys}, "library_ms": sam["library_ms"],
                    "rel_err": {g: sam["rel_err"][g] for g in grads}},
            "symbolic_launches": {"train": symbolic["train"][tname]["launches"][count],
                                  "route": symbolic["train"][tname]["bwd_route_launches"][count][design]},
            "cli_launches": {run: cli[run]["bwd_routes"][count][design] for run in ("fit", "symbolic_fit")},
            "cli_route_launches": {run: cli[run]["bwd_routes"][count] for run in ("fit", "symbolic_fit")},
            "mlm_launches": {"cli_fit": mlm["cli"]["fit"]["bwd_routes"][count][design],
                             "trainer_fit": mlm["cli"]["direct"]["bwd_route_launches"][count][design]},
            "classifiers_launches": {run: routes[count][design] for run, routes in clf_bwd.items()},
            "head_dims": sorted({(c["d"], c["dv"]) for c in mine}), "instantiated_head_dims": HEAD_DIMS,
            "cases": [{"case": c["case"], "i": c["i"], "j": c["j"], "d": c["d"], "dv": c["dv"],
                       "causal": c["causal"],
                       **{k: c["kernels"][kname][k] for k in keys if not k.endswith("_by")},
                       "library_ms": c["library_ms"], "rel_err": {g: c["rel_err"][g] for g in grads},
                       "prev_rel_err": None if c["prev_rel_err"] is None
                       else {g: c["prev_rel_err"][g] for g in grads}}
                      for c in mine],
        })
    return entries


def wide_entries(flash, k1_cases: list, k23_cases: list, k1_launches: int, bwd_launches: dict,
                 clf_k1: dict, clf_bwd: dict, flow_k1: dict) -> tuple:
    """The summary line's entries at the pairs outside ``HEAD_DIMS``, as
    ``(K1's, K2's and K3's)``: each kernel's ``wide_mma`` route and, as the
    earlier design there, its ``wide`` (reached by name only: its times are
    the ``wide_mma`` cases' ``prev_ms``, and the main path launches it no
    time). The image encoder's cross attend in bf16 (d = dv = 261, 512 x
    50176) at the top, ``launches`` from the classifiers phase's bf16 image
    fit, each classifiers run's launches on the route, and every case that
    took it (the flow cases, which no earlier design ran, only under
    ``wide_mma``); ``flow_k1``, each flow run's K1 launches by route."""
    keys = ("plain_ms", "bound_ms", "bound_by", "library_ms")
    head_of = lambda mine: next(c for c in mine if (c["case"], c["dtype"]) == ("img_cross", "bfloat16"))  # noqa: E731
    common = dict(route="cuda", shape="the image classifier's encoder cross attend, b=2 h=1 "
                  "i=512 j=50176 d=dv=261 bf16, non-causal, no pad mask",
                  launches_from="the classifiers phase's bf16 image fit (8 steps and its validation pass)")
    took = [c for c in k1_cases if c["route"] == K1_WIDE_ROUTE]
    head = head_of(took)
    k1 = []
    for design in (K1_WIDE_ROUTE, K1_WIDE_PREV):
        now = design == K1_WIDE_ROUTE
        mine = took if now else [c for c in took if c["prev_ms"] is not None]
        err_key, ms_key = ("max_abs_err", "ms") if now else ("prev_max_abs_err", "prev_ms")
        launches = k1_launches if now else 0
        k1.append({
            "name": f"flash_attention_fwd[{design}]", **common, "design": design, "source": K1_SOURCES[design],
            "replaces": "perceiver_io_tpu/ops/flash_attention.py:198", "launches": launches,
            "kernel_launches": launches * flash.ROUTE_KERNELS[design],
            **({} if now else {"launches_note": "the earlier design, reached by name only: its times "
                                                f"are the {K1_WIDE_ROUTE} cases' prev_ms"}),
            "max_abs_err": max(c[err_key] for c in mine if c["dtype"] == "float32"),
            "max_abs_err_bf16": max(c[err_key] for c in mine if c["dtype"] == "bfloat16"),
            "ms": head[ms_key], **({"prev_ms": head["prev_ms"], "prev_route": K1_WIDE_PREV} if now else {}),
            **{k: head[k] for k in keys}, "library_backend": head["library_backend"],
            "classifiers_launches": {run: routes.get(design, 0) for run, routes in clf_k1.items()},
            "flow_launches": {run: routes.get(design, 0) for run, routes in flow_k1.items()},
            "head_dims": sorted({(c["d"], c["dv"]) for c in mine}),
            "cases": [{"case": c["case"], "dtype": c["dtype"], "b": c["b"], "h": c["h"], "i": c["i"], "j": c["j"],
                       "d": c["d"], "dv": c["dv"], "causal": c["causal"], "misaligned": c["misaligned"],
                       "max_abs_err": c[err_key], "ms": c[ms_key], **({"prev_ms": c["prev_ms"]} if now else {}),
                       "library_backend": c["library_backend"],
                       **{k: c[k] for k in keys + ("bound_simt_ms",) if k in c and not k.endswith("_by")}}
                      for c in mine],
        })
    entries = []
    mine = [c for c in k23_cases if c["expected_route"] == K23_WIDE_ROUTE]
    head = head_of(mine)
    for design in (K23_WIDE_ROUTE, K23_WIDE_PREV):
        now = design == K23_WIDE_ROUTE
        err_key, ms_key = ("max_abs_err", "ms") if now else ("prev_max_abs_err", "prev_ms")
        for kname in ("dq", "dkv"):
            name, replaces, count, grads = K23_KERNELS[kname]
            entries.append({
                "name": f"{name}[{design}]", **common, "design": design, "source": K23_SOURCES[design],
                "replaces": replaces, "launches": bwd_launches[count] if now else 0,
                **({} if now else {"launches_note": "the earlier design, reached by name only: its times "
                                                    f"are the {K23_WIDE_ROUTE} cases' prev_ms"}),
                "max_abs_err": max(c[err_key][g] for c in mine for g in grads if c["dtype"] == "float32"),
                "max_abs_err_bf16": max(c[err_key][g] for c in mine for g in grads if c["dtype"] == "bfloat16"),
                "ms": head["kernels"][kname][ms_key],
                **({"prev_ms": head["kernels"][kname]["prev_ms"], "prev_route": K23_WIDE_PREV} if now else {}),
                **{k: head["kernels"][kname][k] for k in ("plain_ms", "bound_ms", "bound_by")},
                "library_ms": head["library_ms"], "library_backend": head["library_backend"],
                "library_note": f"backward of scaled_dot_product_attention ({head['library_backend']} backend), "
                                "dq, dk and dv together",
                "classifiers_launches": {run: routes[count][design] for run, routes in clf_bwd.items()},
                "head_dims": sorted({(c["d"], c["dv"]) for c in mine}),
                "cases": [{"case": c["case"], "dtype": c["dtype"], "b": c["b"], "h": c["h"], "i": c["i"],
                           "j": c["j"], "d": c["d"], "dv": c["dv"], "causal": c["causal"],
                           "rel_err": {g: c["rel_err" if now else "prev_rel_err"][g] for g in grads},
                           "ms": c["kernels"][kname][ms_key],
                           **({"prev_ms": c["kernels"][kname]["prev_ms"]} if now else {}),
                           **{k: c["kernels"][kname][k] for k in ("plain_ms", "bound_ms", "bound_simt_ms")
                              if k in c["kernels"][kname]},
                           "library_ms": c["library_ms"], "library_backend": c["library_backend"]} for c in mine],
            })
    return k1, entries


#: K1-K3 kernels templated on (D, DV): ptxas_by_kernel keys them "DxDV"
PAIR_KERNELS = ("flash_fwd_split_kernel", "flash_fwd_wgmma_kernel", "flash_fwd_tf32x3_kernel",
                "flash_bwd_dq_wgmma_kernel", "flash_bwd_dkv_wgmma_kernel", "flash_bwd_dq_tf32x3_kernel",
                "flash_bwd_dkv_tf32x3_kernel")
#: K1-K3's wide_mma kernels, templated on (type, query rows a tile[, K1's
#: accumulator column pairs]): keyed "<type> rows <n>[ pairs <p>]"
ROWS_KERNELS = ("flash_fwd_wide_mma_kernel", "flash_bwd_dq_wide_mma_kernel", "flash_bwd_dkv_wide_mma_kernel")
#: kernels templated on the type alone: keyed "<type>"
TYPE_KERNELS = ("flash_fwd_wide_mma_cols_kernel", "flash_fwd_wide_mma_merge_kernel")


def ptxas_by_kernel(log: str) -> dict:
    """``nvcc -Xptxas -v`` output as {kernel: {instances, registers [min,
    max], max spill store bytes, and the same per head dim}}, kernels named
    by their function name, head dims read from the ``int`` template
    arguments of the mangled name: the first (every kernel's first is its
    head dim), "DxDV" from the first two for :data:`PAIR_KERNELS`, the
    type and query rows for :data:`ROWS_KERNELS`, or the type for
    :data:`TYPE_KERNELS`."""
    out = {}
    name = dim = None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(.*?\d+((?:flash|ragged)_\w*?kernel)\w*)'", line)
        if entry:
            name = entry.group(2)
            ints = re.findall(r"Li(\d+)E", entry.group(1)[entry.group(1).index(name):])
            tname = "bf16" if "__nv_bfloat16" in entry.group(1) else "fp32"
            if name in ROWS_KERNELS and ints:  # K1's also takes its accumulator's column pairs
                dim = f"{tname} rows {ints[0]}" + (f" pairs {ints[1]}" if len(ints) > 1 else "")
            elif name in TYPE_KERNELS:
                dim = tname
            else:
                dim = (f"{ints[0]}x{ints[1]}" if name in PAIR_KERNELS and len(ints) > 1
                       else int(ints[0]) if ints else None)
            rec = out.setdefault(name, {"instances": 0, "registers": [], "max_spill_store_bytes": 0,
                                        "by_head_dim": {}})
            rec["instances"] += 1
            rec["by_head_dim"].setdefault(dim, {"registers": [], "max_spill_store_bytes": 0})
        elif name and "Used" in line and "registers" in line:
            regs = int(re.search(r"Used (\d+) registers", line).group(1))
            out[name]["registers"].append(regs)
            out[name]["by_head_dim"][dim]["registers"].append(regs)
        elif name and "spill stores" in line:
            spill = int(re.search(r"(\d+) bytes spill stores", line).group(1))
            for rec in (out[name], out[name]["by_head_dim"][dim]):
                rec["max_spill_store_bytes"] = max(rec["max_spill_store_bytes"], spill)
    for rec in out.values():
        for r in (rec, *rec["by_head_dim"].values()):
            r["registers"] = [min(r["registers"], default=0), max(r["registers"], default=0)]
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from perceiver_io_tpu_torch import _build
    from perceiver_io_tpu_torch.data.text import tokenizers as tokenizers_mod
    from perceiver_io_tpu_torch.inference import beam as beam_mod
    from perceiver_io_tpu_torch.inference import decode_strategy as strategy_mod
    from perceiver_io_tpu_torch.inference import generate as gen_mod
    from perceiver_io_tpu_torch.inference import pipelines as pipelines_mod
    from perceiver_io_tpu_torch.inference import samplers
    from perceiver_io_tpu_torch.inference import speculative as spec_mod
    from perceiver_io_tpu_torch.data import audio as data_audio
    from perceiver_io_tpu_torch.models import audio as sam
    from perceiver_io_tpu_torch.models.core import modules
    from perceiver_io_tpu_torch.models.text import clm
    from perceiver_io_tpu_torch.ops import flash_attention as flash
    from perceiver_io_tpu_torch.ops import paged_attention as paged
    from perceiver_io_tpu_torch.ops import ragged_attention as ragged
    from perceiver_io_tpu_torch.serving import buckets
    from perceiver_io_tpu_torch.serving import engine as engine_mod
    from perceiver_io_tpu_torch.serving import slots as slots_mod
    from perceiver_io_tpu_torch import parallel, reliability, training

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    emit("device", nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
         kind=torch.cuda.get_device_name(0), count=torch.cuda.device_count())

    t0 = time.perf_counter()
    timed("build", _build.build_all)
    emit("build", seconds=time.perf_counter() - t0, sources=_build.sources(),
         ptxas={name: ptxas_by_kernel(log) for name, log in _build.BUILD_LOG.items()})
    cases = timed("kernel", kernel_cases, torch, flash)
    timed("k1_refusals", k1_refusals, torch, flash)
    timed("model", model_phase, torch, clm, flash, gen_mod, smi)
    base = clm.CausalLanguageModel(clm_base_config(clm.CausalLanguageModelConfig), dtype=torch.float32,
                                   seed=0).eval()
    served = timed("serve", serve_phase, torch, flash, gen_mod, engine_mod, base,
                   *serve_workload(torch, gen_mod, buckets, base.config.vocab_size))
    k4 = timed("k4", k4_cases, torch, ragged, paged)
    timed("k4_refusals", k4_refusals, torch, ragged)
    slot_launches, serve = timed(
        "slot_serve", slot_serve_phase, torch, flash, ragged, gen_mod, slots_mod, base,
        buckets.BucketTable(prompt_lens=SLOT_BUCKETS, batch_sizes=(1,)),
        slot_serve_workload(torch, gen_mod, base.config.vocab_size))
    del base
    shallow = timed("shallow_serve", shallow_serve, torch, clm, gen_mod, serve)
    prefix_launches, shared = timed("slot_prefix", slot_prefix_phase, torch, flash, ragged, gen_mod, slots_mod,
                                    buckets, shallow["model"])
    preempt_launches = timed("slot_preempt", slot_preempt_phase, torch, flash, ragged, gen_mod, slots_mod, buckets,
                             shallow, shared, slot_launches["paged"])
    spec_root = ROOT / "build" / "chip_smoke_spec"
    spec_root.mkdir(parents=True, exist_ok=True)
    spec_launches = timed("slot_spec", slot_spec_phase, torch, flash, ragged, gen_mod, spec_mod, strategy_mod,
                          slots_mod, buckets, clm, shallow, slot_launches, spec_root)
    sample = timed("sample", sample_phase, torch, clm, flash, ragged, gen_mod, samplers, beam_mod, pipelines_mod,
                   tokenizers_mod, engine_mod, slots_mod, buckets, shallow, slot_launches)
    # obs and fleet run over the shallow model too (cuts of depth that
    # pay for phase 14c)
    obs = timed("obs", obs_phase, torch, flash, ragged, gen_mod, slots_mod, buckets, shallow,
                ROOT / "build" / "chip_smoke_obs", smi)
    fleet = timed("fleet", fleet_phase, torch, flash, ragged, gen_mod, slots_mod, buckets, shallow, smi)
    del serve, shared, shallow
    emit("memory_before_training", **held_memory(torch))
    k23 = timed("k23", k23_cases, torch, flash)
    train_root = ROOT / "build" / "chip_smoke_train"
    shutil.rmtree(train_root, ignore_errors=True)
    fits = timed("train", train_phase, torch, clm, flash, ragged, training, parallel, train_root)
    emit("memory_before_train_resilience", **held_memory(torch))
    resilience = timed("train_resilience", train_resilience_phase, torch, clm, flash, parallel, training, modules,
                       reliability, pipelines_mod, ROOT / "build" / "chip_smoke_resilience")
    emit("memory_before_mesh", **held_memory(torch))
    # phase 14c's world of four starts now and waits for the card
    shard_started = start_shard_ranks(clm_base_config(clm.CausalLanguageModelConfig),
                                      ROOT / "build" / "chip_smoke_shard")
    try:
        mesh = timed("mesh", mesh_phase, torch, clm, flash, parallel, training, ROOT / "build" / "chip_smoke_mesh",
                     smi)
    except BaseException:
        finish_mesh_ranks_abort(shard_started)
        raise
    shard = timed("shard", shard_phase, torch, shard_started, mesh["shard_a"], smi)
    emit("memory_before_symbolic", **held_memory(torch))
    symbolic = timed("symbolic", symbolic_phase, torch, sam, flash, ragged, gen_mod, engine_mod, slots_mod, buckets,
                     pipelines_mod, training, parallel, data_audio, ROOT / "build" / "chip_smoke_symbolic")
    emit("memory_before_cli", **held_memory(torch))
    cli = timed("cli", cli_phase, torch, flash, ragged, gen_mod, engine_mod, training, parallel,
                ROOT / "build" / "chip_smoke_cli", smi)
    emit("memory_before_mlm", **held_memory(torch))
    mlm = timed("mlm", mlm_phase, torch, flash, ragged, pipelines_mod, training, parallel,
                ROOT / "build" / "chip_smoke_mlm", smi)
    mlm_k1 = {**{f"forward_{k}": v["k1_route_launches"] for k, v in mlm["forward"].items()},
              "fill_mask": mlm["fill"]["k1_route_launches"],
              **{run: mlm["cli"][run]["k1_routes"] for run in ("fit", "validate", "test")}}
    emit("memory_before_classifiers", **held_memory(torch))
    clf = timed("classifiers", classifiers_phase, torch, flash, ragged, pipelines_mod, training, parallel,
                ROOT / "build" / "chip_smoke_classifiers", smi)
    # each classifiers run's K1 launches by route, and K2/K3's in its fits
    clf_k1 = {**{f"text_forward_{k}": v["k1_route_launches"] for k, v in clf["forward"].items()},
              "sentiment_analysis": clf["sentiment"]["k1_route_launches"],
              **{f"text_cli_{run}": clf["cli"][run]["k1_routes"] for run in ("frozen", "unfrozen", "validate", "test")},
              **{f"image_forward_{k}": v["k1_route_launches"] for k, v in clf["image"].items()},
              "image_classification": clf["image_pipeline"]["k1_route_launches"],
              "image_fit": clf["image_fit"]["k1_route_launches"],
              **{f"mnist_cli_{run}": clf["mnist_cli"][run]["k1_routes"] for run in ("fit", "validate", "test")}}
    clf_bwd = {"text_cli_frozen": clf["cli"]["frozen"]["bwd_routes"],
               "text_cli_unfrozen": clf["cli"]["unfrozen"]["bwd_routes"],
               "image_fit": clf["image_fit"]["bwd_route_launches"], "mnist_cli_fit": clf["mnist_cli"]["fit"]["bwd_routes"]}
    emit("memory_before_flow", **held_memory(torch))
    flow = timed("flow", flow_phase, torch, flash, pipelines_mod, smi)
    # the flow runs' K1 launches by route: a forward per type, the pipeline's micro-batches
    flow_k1 = {**{f"forward_{k}": v["k1_route_launches"] for k, v in flow["forward"].items()},
               "optical_flow_pipeline": flow["pipeline"]["k1_route_launches"]}
    k1_wide, k23_wide = wide_entries(flash, cases, k23, clf["image_fit"]["k1_route_launches"][K1_WIDE_ROUTE],
                        {k: v[K23_WIDE_ROUTE] for k, v in clf["image_fit"]["bwd_route_launches"].items()}, clf_k1,
                        clf_bwd, flow_k1)
    emit("phase_seconds", total=time.perf_counter() - T_START, seconds=PHASE_SECONDS)

    main_case = next(c for c in cases
                     if (c["case"], c["dtype"], c["d"]) == ("cross", "float32", K1_HEAD_DIM))
    route_launches = {"split": served["k1_routes"]["split"], "tf32x3": served["k1_routes"]["tf32x3"],
                      "wgmma": fits["bfloat16"]["k1_route_launches"]["wgmma"]}
    k4_case = next(c for c in k4 if (c["case"], c["layout"], c["d"]) == ("decode", "float32", K1_HEAD_DIM))
    k4_paged = slot_launches["paged"]
    print(json.dumps({"kernels": [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": K1_SOURCES["tf32x3"],
        "replaces": "perceiver_io_tpu/ops/flash_attention.py:198",
        "launches": served["k1"],
        "kernel_launches": served["k1_kernels"],
        "max_abs_err": max(c["max_abs_err"] for c in cases if c["dtype"] == "float32"),
        "ms": main_case["ms"],
        "prev_ms": main_case["prev_ms"],
        "prev_route": "simt",
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "bound_simt_ms": main_case["bound_simt_ms"],
        "library_ms": main_case["library_ms"],
        "library_backend": main_case["library_backend"],
        "shape": "cross-attention b=4 h=8 i=512 j=1024 d=112 fp32 (route tf32x3), causal, left pads; "
                 "launches: the bucket serve run",
        "slot_spec_launches": {run: v["k1"] for run, v in spec_launches.items()},
        "slot_spec_route_launches": {run: v["k1_routes"] for run, v in spec_launches.items()},
        "slot_spec_rounds": {run: v["rounds"] for run, v in spec_launches.items()},
        "sample_launches": {run: v["k1"] for run, v in sample["runs"].items()},
        "sample_route_launches": {run: v["k1_routes"] for run, v in sample["runs"].items()},
        "beam_launches": sample["beam"]["k1"],
        "obs_launches": obs["k1"],
        "obs_route_launches": obs["k1_routes"],
        "fleet_launches": {run: v["k1"] for run, v in fleet.items()},
        "fleet_route_launches": {run: v["k1_routes"] for run, v in fleet.items()},
        "beam_route_launches": sample["beam"]["k1_routes"],
        "train_resilience_launches": {run: v["k1"] for run, v in resilience.items()},
        "cli_launches": {run: r["launches"]["k1"] + r["validation_launches"]["k1"] for run, r in cli.items()},
        "cli_route_launches": {run: r["k1_routes"] for run, r in cli.items()},
        "symbolic_launches": {"bucket_serve": symbolic["bucket_serve"]["k1"],
                              **{f"slot_serve_{layout}": v["k1"] for layout, v in symbolic["slot_serve"].items()},
                              **{f"train_{t}": v["launches"]["k1"] for t, v in symbolic["train"].items()}},
        "mlm_launches": {run: sum(routes.values()) for run, routes in mlm_k1.items()},
        "mlm_route_launches": mlm_k1,
        "classifiers_launches": {run: sum(routes.values()) for run, routes in clf_k1.items()},
        "classifiers_route_launches": clf_k1,
        "flow_launches": {run: sum(routes.values()) for run, routes in flow_k1.items()},
        "flow_route_launches": flow_k1,
        "mesh_route_launches": mesh_launches(mesh, "k1"),
        "shard_route_launches": shard_launches(shard, "k1"),
        "routes": [{**k1_route_entry(flash, design, main, cases, route_launches[design], {
                       "bucket_serve": symbolic["bucket_serve"]["k1_routes"][design],
                       **{f"slot_serve_{layout}": v["k1_routes"][design]
                          for layout, v in symbolic["slot_serve"].items()},
                       **{f"train_{t}": v["k1_route_launches"][design] for t, v in symbolic["train"].items()}}),
                    "cli_launches": {run: r["k1_routes"][design] for run, r in cli.items()},
                    "mlm_launches": {run: routes[design] for run, routes in mlm_k1.items()},
                    "classifiers_launches": {run: routes.get(design, 0) for run, routes in clf_k1.items()},
                    "flow_launches": {run: routes.get(design, 0) for run, routes in flow_k1.items()}}
                   for design, main in (("split", ("decode", "float32")), ("wgmma", ("cross", "bfloat16")),
                                        ("tf32x3", ("cross", "float32")))] + k1_wide,
    }, {
        "name": "ragged_paged_attention",
        "route": "cuda",
        "source": K4_SOURCES["split"],
        "replaces": K4_REPLACES,
        "launches": k4_paged["k4"],
        "kernel_launches": k4_paged["k4_kernels"],
        "max_abs_err": max(c["max_abs_err"] for c in k4 if c["layout"] != "bfloat16"),
        "ms": k4_case["ms"],
        "prev_ms": k4_case["prev_ms"],
        "prev_route": "simt",
        "plain_ms": k4_case["plain_ms"],
        "bound_ms": k4_case["bound_ms"],
        "bound_by": k4_case["bound_by"],
        "library_ms": None,
        "gather_sdpa_ms": k4_case["gather_sdpa_ms"],
        "shape": "decode b=8 h=8 q_len=1 d=112 fp32 (route split), block 16, lengths 0..1023; "
                 "launches: the paged slot-serve run",
        "slot_prefix_launches": prefix_launches["paged"]["k4"],
        "slot_prefix_kernel_launches": prefix_launches["paged"]["k4_kernels"],
        "slot_preempt_launches": {run: launches["k4"] for run, launches in preempt_launches.items()},
        "slot_preempt_kernel_launches": {run: launches["k4_kernels"]
                                         for run, launches in preempt_launches.items()},
        "slot_spec_launches": {run: v["k4"] for run, v in spec_launches.items()},
        "sample_launches": {run: v["k4"] for run, v in sample["runs"].items()},
        "sample_route_launches": {run: v["k4_routes"] for run, v in sample["runs"].items()},
        "obs_launches": obs["k4"],
        "obs_route_launches": obs["k4_routes"],
        "fleet_launches": {run: v["k4"] for run, v in fleet.items()},
        "fleet_route_launches": {run: v["k4_routes"] for run, v in fleet.items()},
        "symbolic_launches": {f"slot_serve_{layout}": v["k4"] for layout, v in symbolic["slot_serve"].items()},
        "cli_launches": {run: cli[run]["launches"]["k4"] for run in CLI_SERVE_RUNS},
        "cli_route_launches": {run: cli[run]["k4_routes"] for run in CLI_SERVE_RUNS},
        "shard_route_launches": shard_launches(shard, "k4"),
        "routes": [{**k4_route_entry(ragged, design, main, k4, k4_paged["k4_routes"][design],
                                     prefix_launches["paged"]["k4_routes"][design],
                                     {run: launches["k4_routes"][design]
                                      for run, launches in preempt_launches.items()},
                                     {f"slot_serve_{layout}": v["k4_routes"][design]
                                      for layout, v in symbolic["slot_serve"].items()}),
                    "cli_launches": {run: cli[run]["k4_routes"][design] for run in CLI_SERVE_RUNS}}
                   for design, main in (("split", ("decode", "float32")), ("tc", ("window", "float32")))],
    }] + [{**e, "mesh_route_launches": mesh_launches(mesh, K23_KERNELS[kname][2])}
          for kname in ("dq", "dkv") for e in k23_entries(kname, fits, k23, resilience, symbolic, cli, mlm, clf_bwd)]
        + k23_wide}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-rank"]:
        sys.exit(mesh_rank_main(sys.argv[2:]))
    sys.exit(shard_rank_main(sys.argv[2:]) if sys.argv[1:2] == ["--shard-rank"] else main())
