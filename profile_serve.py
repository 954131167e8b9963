#!/usr/bin/env python3
"""Where the serve (or train) time goes on the card.

    python3 profile_serve.py                                   # bucket engine
    python3 profile_serve.py --engine slots --kv-layout paged  # slot engine
    python3 profile_serve.py --engine slots --kv-layout paged \
        --prefill-chunk 128 --prefix-cache on                  # chunking, prefix sharing
    python3 profile_serve.py --engine slots --kv-layout paged \
        --preemption swap --kv-blocks 160                      # a pressured pool
    python3 profile_serve.py --engine slots --speculation k4d2 # speculative rounds
    python3 profile_serve.py --engine slots --kv-layout auto   # the autotuned layout
    python3 profile_serve.py --engine slots --do-sample        # sampled decoding
    python3 profile_serve.py --num-beams 4                     # beam search, bucket engine
    python3 profile_serve.py --engine train                    # one train step
    python3 profile_serve.py --model sam [--engine slots --kv-layout paged | --engine train]
    python3 profile_serve.py --model mlm --engine train        # the masked LM's fit step
    python3 profile_serve.py --model image --engine train      # the image classifier's fit step
    python3 profile_serve.py --model image --engine train --wide-bwd-route wide
    python3 profile_serve.py --model image --engine train --wide-fwd-route wide
    python3 profile_serve.py --model flow --engine forward     # the optical-flow forward

``--engine bucket`` (default) serves the 8-request workload of
``chip_smoke.py``'s serve phase through ``ServingEngine``; ``--engine
slots`` serves the 12-request workload of its slot-serve phase through
``SlotServingEngine`` (4 slots) in the ``--kv-layout`` given (dense or
paged), or, with ``--prefill-chunk`` or ``--prefix-cache on``, the
12-request workload of its slot-prefix phase (one shared 384-token system
prompt) with those settings; each pass starts a fresh engine, so its prefix
index starts empty. ``--preemption`` (recompute, swap or auto) with
``--kv-blocks`` and ``--admit-headroom-blocks`` serves the slot-preempt
phase's traffic instead: the same requests, every third interactive and
arriving 8 decode steps after the rest, so the pool's pressure preempts at
admission and at decode (the swap copies and the replayed prefills show in
the breakdown, and the line gives the preemption counts). ``--speculation``
(a mode of ``decode_strategy.SPECULATION_CHOICES``) decodes by draft/verify
rounds: the line adds the rounds, the acceptance, K1's device ms and
launches over the rounds (the prefills' included) and the GEMMs' share of
device time. ``--kv-layout
auto`` runs the KV-layout autotuner once (its verdict and timings are in
the line) and serves in the layout it picked. ``--do-sample`` samples every
request with ``chip_smoke.SAMPLE_TOP`` (temperature 0.8, top-k 50, top-p
0.95) from a seeded generator, either engine; the line adds the sampler's
device ms (its sorts, scans, top-k and random draws, by kernel name) a
decode step. ``--num-beams K`` (bucket engine) beam-searches every request
with K beams: each step a full-window forward over ``b·K`` lanes; the line
adds the beam steps and the device ms a step. Both over the
full-width CLM (random weights from a seed) on one GPU, in fp32 and in bf16
compute. ``--model sam`` runs the symbolic-audio model at GiantMIDI width
instead (6144 context, 2048 latents, 768 channels, 12 layers; random
weights from a seed) over the traffic of ``chip_smoke.py``'s symbolic
phase: (b)'s 8 requests through the bucket engine, (c)'s 8 through the slot
engine, or (e)'s optimizer steps (8 rows x 6144 event ids from
``SyntheticSymbolicAudioDataModule``, 2 microbatches, AdamW to 2e-4, prefix
dropout 0.5; loss tokens 8 x 2048 a step). ``--model mlm --engine train``
takes the optimizer steps of the ``mlm`` phase's CLI fit: the masked LM at
language-perceiver width (random weights from a seed), 8 rows x 2048 byte
ids of ``SyntheticTextDataModule`` with word masking, 2 microbatches,
AdamW to 2e-5, clipping; its tokens are the 8 x 2048 input positions a
step. ``--model image --engine train`` takes the optimizer steps of the
``classifiers`` phase's image fit: the Fourier image classifier at
deepmind/vision-perceiver-fourier width (random weights from a seed), 8
synthetic 224 x 224 x 3 images a step in 2 microbatches, AdamW to 1e-4,
clipping; its tokens are the 8 images. Its encoder's cross attend (261,
261) and decoder's query (1024, 1024) are the pairs outside ``HEAD_DIMS``:
K1, K2 and K3 take ``wide_mma`` there; ``--wide-fwd-route wide`` puts K1
and ``--wide-bwd-route wide`` K2 and K3 on the earlier design by name, so
two runs in one call break down the same step on both. ``--model flow
--engine forward`` takes the ``flow`` phase's forward: the optical-flow
Perceiver IO at deepmind/optical-flow-perceiver width (random weights from a
seed) over 2 synthetic frame pairs of 368 x 496 patch features; its line
gives the forward ms, images/s, the peak allocation, K1's launches and
device ms by route (the two cross attends on ``wide_mma``, the 24
self-attends on the tile route of the type), the dense products' device
ms and share, and its images are its tokens (one warm-up forward, three
timed, one profiled). For each: one warm-up pass, one timed pass
(host clock around work that ends in a synchronise), and one pass under
``torch.profiler``. ``--engine train`` instead runs optimizer steps of
``chip_smoke.py``'s ``Trainer.fit`` run (8 rows x 1024 tokens, 2
microbatches, AdamW, clipping, prefix dropout 0.5): two warm-up steps, three
timed steps (each ending in a synchronise), one profiled step; its line
also gives the shares of the backward kernels (K2, K3), and its tokens are
the loss tokens (rows x 512 latents per step). Prints one JSON line per
compute type: tokens/s, the device's busy share (kernel device time of the
profiled pass over the timed pass's wall time, one stream), the shares and
launches of the flash attention kernels (K1; K2 and K3 when training) and
the ragged paged-attention kernel (K4), K1's device time and launches by
route (split, wgmma, tf32x3, wide_mma, wide, and simt, which no traffic
takes) and its device kernel launches (a split-, wide_mma- or wide-route
call launches two: partials and merge), K4's device time, launches and device kernel launches
by route (split, tc, and simt, which no traffic takes; a split-route call
launches two), K2's and K3's device time and launches by route (wgmma,
tf32x3, wide_mma, wide, simt) when training, and the top kernels by device
time.
The full profiler tables go to
``chiprun_out/profile_serve_<engine>[_<layout>]_<dtype>.txt``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


#: kernel-name patterns of the dense products (cuBLAS's and CUTLASS's GEMMs and GEMVs)
GEMM_PATTERNS = ("gemm", "gemv", "nvjet")
#: kernel-name patterns of the sampler's own work: the sorts and scans of
#: top-p, top-k's selection and the uniform draw
SAMPLER_PATTERNS = ("sort", "scan", "topk", "distribution", "uniform")


def _decoding(args, chip_smoke, samplers, cfg):
    """``cfg`` with the flags' decoding: sampled, beams, or greedy."""
    if args.do_sample:
        cfg = dataclasses.replace(cfg, sampling=samplers.SamplingConfig(
            do_sample=True, **chip_smoke.SAMPLE_TOP))
    return dataclasses.replace(cfg, num_beams=args.num_beams)


def _workload(args, torch, chip_smoke, gen_mod, samplers, buckets, slots_mod, engine_mod,
              vocab_size):
    """``(make_engine, run, tokens, steps)`` for the chosen engine; ``steps``
    are the bucket engine's decode steps (each group is one micro-batch),
    None for the slot engine, which counts its own. Each engine samples
    from a generator seeded alike, so every pass draws the same."""
    def generator():
        return torch.Generator(device="cuda").manual_seed(chip_smoke.SAMPLE_SEEDS[0])

    if args.engine == "bucket":
        if args.model == "sam":
            from perceiver_io_tpu_torch.data.audio import midi

            table = buckets.BucketTable(prompt_lens=chip_smoke.SAM_BUCKETS, batch_sizes=(4,))
            work = chip_smoke.sam_workload(torch, gen_mod, midi)
        else:
            table, work = chip_smoke.serve_workload(torch, gen_mod, buckets, vocab_size)
        work = [(_decoding(args, chip_smoke, samplers, c), p) for c, p in work]

        def make(model):
            return engine_mod.ServingEngine(model, table=table, generator=generator())

        def run(engine):
            for c, prompts in work:
                engine.serve(prompts, c)

        return (make, run, sum(c.max_new_tokens * len(p) for c, p in work),
                sum(c.max_new_tokens for c, _ in work))

    prefix_workload = args.prefill_chunk is not None or args.prefix_cache == "on"
    if args.model == "sam":
        from perceiver_io_tpu_torch.data.audio import midi

        gcfg, prompts, news = chip_smoke.sam_slot_workload(torch, gen_mod, midi)
        table = buckets.BucketTable(prompt_lens=chip_smoke.SAM_SLOT_BUCKETS, batch_sizes=(1,))
    else:
        workload = chip_smoke.slot_prefix_workload if prefix_workload else chip_smoke.slot_serve_workload
        gcfg, prompts, news = workload(torch, gen_mod, vocab_size)
        table = buckets.BucketTable(prompt_lens=chip_smoke.SLOT_BUCKETS, batch_sizes=(1,))
    gcfg = _decoding(args, chip_smoke, samplers, gcfg)

    configs = [dataclasses.replace(gcfg, max_new_tokens=k) for k in news]

    def make(model):
        return slots_mod.SlotServingEngine(model, gcfg, table, slots=4, kv_layout=args.kv_layout,
                                           prefill_chunk=args.prefill_chunk,
                                           prefix_cache=args.prefix_cache, kv_blocks=args.kv_blocks,
                                           preemption=args.preemption,
                                           admit_headroom_blocks=args.admit_headroom_blocks,
                                           speculation=args.speculation, generator=generator())

    def run(engine):
        if args.preemption != "off":
            chip_smoke.drive_preempt(engine, prompts, configs, chip_smoke.preempt_tags(len(prompts)))
            return
        for p, c in zip(prompts, configs):
            engine.submit(p, c)
        engine.run_until_idle()

    return make, run, sum(news), None


def _breakdown(torch, prof, table_path: Path):
    """``(kernels, device_ms, ms_of)`` of a profiled pass: its device
    kernels by device time, their sum, and the device ms of the kernels whose
    name holds a pattern. Writes the profiler table to ``table_path``."""
    events = prof.key_averages()
    # a user annotation on the device timeline (the optimizer's step) spans
    # kernels that are listed on their own: counting it would count them twice
    kernels = [e for e in events
               if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False) and _device_us(e) > 0]
    kernels.sort(key=_device_us, reverse=True)
    table_path.write_text(events.table(sort_by="self_cuda_time_total", row_limit=60))

    def ms_of(pattern: str) -> float:
        return sum(_device_us(e) for e in kernels if pattern in e.key) / 1e3

    return kernels, sum(_device_us(e) for e in kernels) / 1e3, ms_of


def _k1_routes(ms_of) -> dict:
    """K1's device ms by route (kernel names: ``flash_fwd_kernel`` simt,
    ``flash_fwd_wgmma_kernel``, ``flash_fwd_tf32x3_kernel``,
    ``flash_fwd_split_kernel`` and its merge, ``flash_fwd_wide_mma_kernel``,
    ``flash_fwd_wide_mma_cols_kernel`` and their merge, ``flash_fwd_wide_kernel``
    and its merge; no pattern is part of another route's name)."""
    return {"simt": ms_of("flash_fwd_kernel"), "wgmma": ms_of("flash_fwd_wgmma_"),
            "tf32x3": ms_of("flash_fwd_tf32x3_"), "split": ms_of("flash_fwd_split_"),
            "wide_mma": ms_of("flash_fwd_wide_mma_"),
            "wide": ms_of("flash_fwd_wide_kernel") + ms_of("flash_fwd_wide_merge_")}


def _k4_routes(ms_of) -> dict:
    """K4's device ms by route (kernel names: ``ragged_decode_kernel`` and
    ``ragged_window_kernel`` simt, ``ragged_split_kernel`` and its merge,
    ``ragged_tc_kernel``)."""
    return {"simt": ms_of("ragged_decode_kernel") + ms_of("ragged_window_kernel"),
            "split": ms_of("ragged_split_"), "tc": ms_of("ragged_tc_")}


def _bwd_routes(ms_of, kernel: str) -> dict:
    """K2's (``kernel`` "dq") or K3's ("dkv") device ms by route (kernel
    names: ``flash_bwd_<kernel>_kernel`` simt, ``flash_bwd_<kernel>_wgmma_kernel``,
    ``flash_bwd_<kernel>_tf32x3_kernel``, ``flash_bwd_<kernel>_wide_mma_kernel``
    and ``flash_bwd_dq_wide_mma_sum_kernel``, ``flash_bwd_<kernel>_wide_kernel``
    and ``flash_bwd_dq_wide_sum_kernel``; no pattern is part of another
    route's name)."""
    return {"simt": ms_of(f"flash_bwd_{kernel}_kernel"), "wgmma": ms_of(f"flash_bwd_{kernel}_wgmma_kernel"),
            "tf32x3": ms_of(f"flash_bwd_{kernel}_tf32x3_kernel"),
            "wide_mma": ms_of(f"flash_bwd_{kernel}_wide_mma_kernel") + ms_of(f"flash_bwd_{kernel}_wide_mma_sum_"),
            "wide": ms_of(f"flash_bwd_{kernel}_wide_kernel") + ms_of(f"flash_bwd_{kernel}_wide_sum_")}


def _profile_train(torch, profile, ProfilerActivity, chip_smoke, clm, flash, dtype, smi, out_dir, model_name,
                   tag_suffix=""):
    from perceiver_io_tpu_torch import parallel, training

    name = str(dtype).split(".")[-1]
    if model_name == "sam":
        run, tokens = _sam_train_workload(torch, chip_smoke, training, parallel, dtype)
    elif model_name == "mlm":
        run, tokens = _mlm_train_workload(torch, chip_smoke, training, parallel, dtype)
    elif model_name == "image":
        run, tokens = _image_train_workload(torch, chip_smoke, training, parallel, dtype)
    else:
        run, tokens = _train_workload(torch, chip_smoke, clm, training, parallel, dtype)
    run()
    run()  # warm-up
    chip_smoke.reset_counts(flash)
    step_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        run()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    counts = {k: v / 3 for k, v in chip_smoke.read_counts(flash).items()}
    bwd_routes = {k: {r: n / 3 for r, n in v.items()} for k, v in chip_smoke.read_bwd_routes(flash).items()}
    k1_routes = {k: v / 3 for k, v in flash.flash_attention.route_launches.items()}
    k1_kernels = flash.flash_attention.kernel_launches / 3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True) as prof:
        t1 = time.perf_counter()
        run()
        prof_wall_ms = (time.perf_counter() - t1) * 1e3
    table = (f"profile_serve_{model_name}_train_{name}{tag_suffix}.txt" if model_name != "clm"
             else f"profile_serve_train_{name}.txt")
    kernels, device_ms, ms_of = _breakdown(torch, prof, out_dir / table)
    measured = bool(kernels)
    p50 = sorted(step_ms)[1]
    by_kernel = {"k1": ms_of("flash_fwd_"), "k2": sum(_bwd_routes(ms_of, "dq").values()),
                 "k3": sum(_bwd_routes(ms_of, "dkv").values())}
    shares = {}
    for key, ms in by_kernel.items():
        shares[f"{key}_device_ms"] = ms if measured else "not measured"
        shares[f"{key}_share_of_device"] = ms / device_ms if measured else "not measured"
    return {
        "engine": "train", "model": model_name, "compute_dtype": name, "device": smi, "step_ms": step_ms,
        "step_ms_p50": p50, "loss_tokens_per_step": tokens, "loss_tokens_per_s": tokens / (p50 / 1e3),
        "launches_per_step": counts, "k1_route_launches_per_step": k1_routes,
        "k1_kernel_launches_per_step": k1_kernels,
        "profiled_wall_ms": prof_wall_ms,
        "device_kernel_ms": device_ms if measured else "not measured",
        # the profiled step does a timed step's work; the profiler slows the
        # host, so the share against the timed step is the one to read
        "device_busy_share": device_ms / p50 if measured else "not measured",
        "device_busy_share_profiled": device_ms / prof_wall_ms if measured else "not measured",
        **shares,
        "k1_route_device_ms": _k1_routes(ms_of) if measured else "not measured",
        "k2_route_device_ms": _bwd_routes(ms_of, "dq") if measured else "not measured",
        "k3_route_device_ms": _bwd_routes(ms_of, "dkv") if measured else "not measured",
        "bwd_route_launches_per_step": bwd_routes,
        "k123_share_of_device": (sum(ms_of(p) for p in ("flash_fwd_", "flash_bwd_"))
                                 / device_ms) if measured else "not measured",
        "top_kernels": [{"name": e.key[:90], "ms": _device_us(e) / 1e3, "calls": e.count}
                        for e in kernels[:10]],
    }


def _profile_forward(torch, profile, ProfilerActivity, chip_smoke, flash, dtype, smi, out_dir) -> dict:
    """The optical-flow forward (``--model flow --engine forward``): the
    ``flow`` phase's model and ``FLOW_BATCH`` seeded frame pairs; one
    warm-up forward, three timed (each ending in a synchronise), one
    profiled."""
    import numpy as np

    from perceiver_io_tpu_torch.models.vision import optical_flow as flow_mod

    name = str(dtype).split(".")[-1]
    cfg = chip_smoke.flow_config()
    model = flow_mod.OpticalFlow(cfg, dtype=dtype, seed=0).eval()
    b = chip_smoke.FLOW_BATCH
    rng = np.random.default_rng(31)
    x = torch.from_numpy(rng.standard_normal((b, 2, 27, *cfg.encoder.image_shape)).astype(np.float32)).to("cuda")

    def run():
        with torch.no_grad():
            model(x)
        torch.cuda.synchronize()

    run()  # warm-up
    chip_smoke.reset_counts(flash)
    torch.cuda.reset_peak_memory_stats()
    forward_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        run()
        forward_ms.append((time.perf_counter() - t0) * 1e3)
    k1_routes = {k: v / 3 for k, v in flash.flash_attention.route_launches.items() if v}
    k1_kernels = flash.flash_attention.kernel_launches / 3
    peak = torch.cuda.max_memory_allocated()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True) as prof:
        t1 = time.perf_counter()
        run()
        prof_wall_ms = (time.perf_counter() - t1) * 1e3
    kernels, device_ms, ms_of = _breakdown(torch, prof, out_dir / f"profile_serve_flow_forward_{name}.txt")
    measured = bool(kernels)
    p50 = sorted(forward_ms)[1]
    k1_ms = ms_of("flash_fwd_")
    gemm_ms = sum(_device_us(e) for e in kernels if any(p in e.key.lower() for p in GEMM_PATTERNS)) / 1e3
    return {
        "engine": "forward", "model": "flow", "compute_dtype": name, "device": smi, "batch": b,
        "forward_ms": forward_ms, "forward_ms_p50": p50, "images_per_s": b / (p50 / 1e3),
        "peak_memory_bytes": peak, "k1_route_launches_per_forward": k1_routes,
        "k1_kernel_launches_per_forward": k1_kernels,
        "profiled_wall_ms": prof_wall_ms,
        "device_kernel_ms": device_ms if measured else "not measured",
        "device_busy_share": device_ms / p50 if measured else "not measured",
        "device_busy_share_profiled": device_ms / prof_wall_ms if measured else "not measured",
        "k1_device_ms": k1_ms if measured else "not measured",
        "k1_share_of_device": k1_ms / device_ms if measured else "not measured",
        "k1_route_device_ms": _k1_routes(ms_of) if measured else "not measured",
        "gemm_device_ms": gemm_ms if measured else "not measured",
        "gemm_share_of_device": gemm_ms / device_ms if measured else "not measured",
        "top_kernels": [{"name": e.key[:90], "ms": _device_us(e) / 1e3, "calls": e.count}
                        for e in kernels[:10]],
    }


def _image_train_workload(torch, chip_smoke, training, parallel, dtype):
    """``(run, tokens)``: ``run()`` takes one optimizer step of the
    classifiers phase's image fit (the image classifier at
    deepmind/vision-perceiver-fourier width; its two seeded batches of 8
    synthetic images cycled, 2 microbatches, AdamW, clipping) on a fresh
    model; its tokens are the 8 images."""
    import numpy as np

    from perceiver_io_tpu_torch.models import vision as vision_mod
    from perceiver_io_tpu_torch.models.core import config as config_mod

    cfg = chip_smoke.image_classifier_config(config_mod, vision_mod)
    model = vision_mod.ImageClassifier(cfg, dtype=dtype, seed=0)
    schedule = training.cosine_with_warmup(1e-4, warmup_steps=2, training_steps=chip_smoke.TRAIN_STEPS)
    state = parallel.TrainState.create(model, training.make_optimizer(schedule, optimizer="adamw"))
    step = parallel.make_train_step(training.image_classifier_loss_fn(model), grad_clip_norm=1.0,
                                    grad_accum_steps=2)
    rng = np.random.default_rng(29)
    shape = chip_smoke.IMG_ENCODER["image_shape"]
    batches = [{"image": rng.standard_normal((8, *shape)).astype(np.float32),
                "label": rng.integers(0, chip_smoke.IMG_DECODER["num_classes"], 8)} for _ in range(2)]
    turn = [0]

    def run():
        gen = torch.Generator(device="cuda").manual_seed(turn[0])
        _, metrics = step(state, batches[turn[0] % 2], gen)
        turn[0] += 1
        metrics["loss"].item()
        torch.cuda.synchronize()

    return run, 8


def _train_workload(torch, chip_smoke, clm, training, parallel, dtype):
    """``(run, tokens)``: ``run()`` takes one optimizer step of the fit run's
    configuration on a fresh full-width model."""
    cfg = chip_smoke.clm_base_config(clm.CausalLanguageModelConfig)
    model = clm.CausalLanguageModel(cfg, dtype=dtype, seed=0)
    schedule = training.cosine_with_warmup(1e-4, warmup_steps=2, training_steps=chip_smoke.TRAIN_STEPS)
    state = parallel.TrainState.create(model, training.make_optimizer(schedule, optimizer="adamw"))
    step = parallel.make_train_step(training.clm_loss_fn(model, cfg.max_latents), grad_clip_norm=1.0,
                                    grad_accum_steps=2)
    batches = chip_smoke.token_batches(cfg.vocab_size, cfg.max_seq_len, 8, 2, seed=31)
    turn = [0]

    def run():
        gen = torch.Generator(device="cuda").manual_seed(turn[0])
        _, metrics = step(state, batches[turn[0] % 2], gen)
        turn[0] += 1
        metrics["loss"].item()
        torch.cuda.synchronize()

    return run, 8 * cfg.max_latents


def _sam_train_workload(torch, chip_smoke, training, parallel, dtype):
    """``(run, tokens)``: ``run()`` takes one optimizer step of the symbolic
    phase's fit on a fresh GiantMIDI-width model."""
    from perceiver_io_tpu_torch.data import audio as data_audio
    from perceiver_io_tpu_torch.models import audio as sam

    cfg = chip_smoke.giantmidi_config(sam)
    model = sam.SymbolicAudioModel(cfg, dtype=dtype, seed=0)
    schedule = training.cosine_with_warmup(chip_smoke.SAM_LR, warmup_steps=chip_smoke.SAM_WARMUP,
                                           training_steps=chip_smoke.TRAIN_STEPS)
    state = parallel.TrainState.create(model, training.make_optimizer(schedule, optimizer="adamw"))
    step = parallel.make_train_step(training.clm_loss_fn(model, cfg.max_latents), grad_clip_norm=1.0,
                                    grad_accum_steps=2)
    batches, _, _ = chip_smoke.sam_train_batches(data_audio, cfg)
    turn = [0]

    def run():
        gen = torch.Generator(device="cuda").manual_seed(turn[0])
        _, metrics = step(state, batches[turn[0] % 2], gen)
        turn[0] += 1
        metrics["loss"].item()
        torch.cuda.synchronize()

    return run, 8 * cfg.max_latents


def _mlm_train_workload(torch, chip_smoke, training, parallel, dtype):
    """``(run, tokens)``: ``run()`` takes one optimizer step of the mlm
    phase's CLI fit (the masked LM at language-perceiver width; 8 rows x
    2048 byte ids of the synthetic corpus with word masking, 2
    microbatches, AdamW, clipping) on a fresh model; its tokens are the
    rows' input positions."""
    import itertools

    from perceiver_io_tpu_torch.data.text.sources import SyntheticTextDataModule
    from perceiver_io_tpu_torch.models.core import config as config_mod
    from perceiver_io_tpu_torch.models.text import common as common_mod
    from perceiver_io_tpu_torch.models.text import mlm as mlm_mod

    cfg = chip_smoke.language_perceiver_config(config_mod, common_mod, mlm_mod)
    model = mlm_mod.MaskedLanguageModel(cfg, dtype=dtype, seed=0)
    schedule = training.cosine_with_warmup(chip_smoke.CLI_LR, warmup_steps=chip_smoke.CLI_WARMUP,
                                           training_steps=chip_smoke.TRAIN_STEPS)
    state = parallel.TrainState.create(model, training.make_optimizer(schedule, optimizer="adamw"))
    step = parallel.make_train_step(training.mlm_loss_fn(model), grad_clip_norm=1.0, grad_accum_steps=2)
    dm = SyntheticTextDataModule(dataset_dir=str(ROOT / "build" / "profile_serve_mlm"),
                                 max_seq_len=chip_smoke.MLM_SEQ, batch_size=8, num_train_docs=64,
                                 num_valid_docs=8, task="mlm")
    dm.prepare_data()
    dm.setup()
    batches = list(itertools.islice(iter(dm.train_dataloader()), 2))
    turn = [0]

    def run():
        gen = torch.Generator(device="cuda").manual_seed(turn[0])
        _, metrics = step(state, batches[turn[0] % 2], gen)
        turn[0] += 1
        metrics["loss"].item()
        torch.cuda.synchronize()

    return run, 8 * chip_smoke.MLM_SEQ


def main() -> int:
    sys.path.insert(0, str(ROOT))
    from perceiver_io_tpu_torch.inference import decode_strategy as strategy_mod

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--engine", choices=("bucket", "slots", "train", "forward"), default="bucket")
    parser.add_argument("--model", choices=("clm", "sam", "mlm", "image", "flow"), default="clm",
                        help="clm-base, the symbolic-audio model at GiantMIDI width, (--engine train "
                             "only) the masked LM at language-perceiver width or the Fourier image "
                             "classifier at vision-perceiver-fourier width, or (--engine forward only) "
                             "optical flow at optical-flow-perceiver width")
    parser.add_argument("--wide-fwd-route", choices=("wide_mma", "wide"), default="wide_mma",
                        help="K1's route at the (d, dv) pairs outside HEAD_DIMS: wide_mma (the "
                             "wrapper's pick) or the earlier wide design, by name")
    parser.add_argument("--wide-bwd-route", choices=("wide_mma", "wide"), default="wide_mma",
                        help="K2/K3's route at the (d, dv) pairs outside HEAD_DIMS: wide_mma (the "
                             "wrappers' pick) or the earlier wide design, by name")
    parser.add_argument("--kv-layout", choices=("dense", "paged", "auto"), default="dense",
                        help="the slot engine's KV layout ('auto': the autotuner's verdict)")
    parser.add_argument("--speculation", choices=strategy_mod.SPECULATION_CHOICES, default="off",
                        help="the slot engine's speculative decoding mode")
    parser.add_argument("--prefill-chunk", type=int, default=None,
                        help="the slot engine's prefill chunk (runs the slot-prefix workload)")
    parser.add_argument("--prefix-cache", choices=("off", "on"), default="off",
                        help="the slot engine's prefix sharing (runs the slot-prefix workload; "
                             "needs --kv-layout paged)")
    parser.add_argument("--preemption", choices=("off", "recompute", "swap", "auto"), default="off",
                        help="the slot engine's preemption (runs the slot-preempt traffic; needs a "
                             "paged --kv-layout)")
    parser.add_argument("--kv-blocks", type=int, default=None,
                        help="the slot engine's pool size in blocks (default: dense capacity)")
    parser.add_argument("--admit-headroom-blocks", type=int, default=0,
                        help="decode blocks a lazy admission reserves beyond its prompt pages")
    parser.add_argument("--do-sample", action="store_true",
                        help="sample every request (temperature 0.8, top-k 50, top-p 0.95)")
    parser.add_argument("--num-beams", type=int, default=1,
                        help="beam-search every request with this many beams (bucket engine)")
    args = parser.parse_args()
    slot_only = (args.prefill_chunk is not None or args.prefix_cache == "on"
                 or args.preemption != "off" or args.kv_blocks is not None
                 or args.speculation != "off" or args.kv_layout == "auto")
    if args.engine != "slots" and slot_only:
        parser.error("--prefill-chunk, --prefix-cache, --preemption, --kv-blocks, --speculation "
                     "and --kv-layout auto apply to --engine slots")
    if args.num_beams < 1 or (args.num_beams > 1 and (args.engine != "bucket" or args.do_sample)):
        parser.error("--num-beams K > 1 applies to --engine bucket, without --do-sample "
                     "(beam search decodes deterministically)")
    if args.do_sample and args.engine == "train":
        parser.error("--do-sample applies to the serving engines")
    if (args.model == "flow") != (args.engine == "forward"):
        parser.error("--model flow takes --engine forward, and --engine forward --model flow")
    if args.model in ("mlm", "image") and args.engine != "train":
        parser.error(f"--model {args.model} takes --engine train only")
    if args.model == "sam" and (slot_only or args.do_sample or args.num_beams > 1):
        parser.error("--model sam takes --engine and --kv-layout dense|paged only")

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_serve: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from perceiver_io_tpu_torch.inference import generate as gen_mod
    from perceiver_io_tpu_torch.inference import samplers
    from perceiver_io_tpu_torch.models.text import clm
    from perceiver_io_tpu_torch.ops import flash_attention as flash
    from perceiver_io_tpu_torch.ops import ragged_attention as ragged
    from perceiver_io_tpu_torch.serving import buckets
    from perceiver_io_tpu_torch.serving import engine as engine_mod
    from perceiver_io_tpu_torch.serving import slots as slots_mod

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.wide_fwd_route != "wide_mma":
        pick_fwd = flash._fwd_route
        flash._fwd_route = lambda i, dtype, d, dv: (  # noqa: E731
            args.wide_fwd_route if (d, dv) not in flash.HEAD_DIMS else pick_fwd(i, dtype, d, dv))
    if args.wide_bwd_route != "wide_mma":
        pick = flash._bwd_route
        flash._bwd_route = lambda dtype, d, dv: (  # noqa: E731
            args.wide_bwd_route if (d, dv) not in flash.HEAD_DIMS else pick(dtype, d, dv))
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    cfg = chip_smoke.clm_base_config(clm.CausalLanguageModelConfig)
    if args.model == "sam":
        from perceiver_io_tpu_torch.models import audio as sam

        cfg = chip_smoke.giantmidi_config(sam)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    tag = args.engine if args.model == "clm" else f"sam_{args.engine}"
    if args.engine == "slots":
        tag += f"_{args.kv_layout}"
        if args.prefill_chunk is not None:
            tag += f"_chunk{args.prefill_chunk}"
        if args.prefix_cache == "on":
            tag += "_prefix"
        if args.preemption != "off":
            tag += f"_{args.preemption}{args.kv_blocks or ''}"
        if args.speculation != "off":
            tag += f"_{args.speculation}"
    if args.do_sample:
        tag += "_sampled"
    if args.num_beams > 1:
        tag += f"_beams{args.num_beams}"

    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        if args.engine == "forward":
            print(json.dumps(_profile_forward(torch, profile, ProfilerActivity, chip_smoke, flash, dtype, smi,
                                              out_dir)), flush=True)
            torch.cuda.empty_cache()
            continue
        if args.engine == "train":
            suffix = "".join(f"_{which}_{route}" for which, route in (("fwd", args.wide_fwd_route),
                                                                      ("bwd", args.wide_bwd_route))
                             if route != "wide_mma")
            record = _profile_train(torch, profile, ProfilerActivity, chip_smoke, clm, flash, dtype, smi,
                                    out_dir, args.model, suffix)
            print(json.dumps({**record, "wide_fwd_route": args.wide_fwd_route,
                              "wide_bwd_route": args.wide_bwd_route}), flush=True)
            torch.cuda.empty_cache()
            continue
        if args.model == "sam":
            model = sam.SymbolicAudioModel(cfg, dtype=dtype, seed=0).eval()
        else:
            model = clm.CausalLanguageModel(cfg, dtype=dtype, seed=0).eval()
        kv_verdict = None
        if args.kv_layout == "auto":
            # measured once (the registry keys shape and platform, not the
            # compute type); every engine below resolves "auto" to it
            strategy_mod.autotune_kv_layout(model)
            kv_verdict = strategy_mod.kv_entry(model)
        make, run, tokens, steps = _workload(args, torch, chip_smoke, gen_mod, samplers, buckets,
                                      slots_mod, engine_mod, cfg.vocab_size)

        def serve_all():
            engine = make(model)
            run(engine)
            torch.cuda.synchronize()
            return engine

        serve_all()  # warm-up
        chip_smoke.reset_counts(flash)
        chip_smoke.reset_k4_counts(ragged)
        t0 = time.perf_counter()
        engine = serve_all()
        wall_s = time.perf_counter() - t0
        k1_launches = flash.flash_attention.launches
        k1_routes = dict(flash.flash_attention.route_launches)
        k1_kernels = flash.flash_attention.kernel_launches
        k4_launches = ragged.ragged_paged_attention.launches
        k4_routes = dict(ragged.ragged_paged_attention.route_launches)
        k4_kernels = ragged.ragged_paged_attention.kernel_launches
        stats = engine.stats()

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True) as prof:
            t1 = time.perf_counter()
            serve_all()
            prof_wall_s = time.perf_counter() - t1
        kernels, device_ms, ms_of = _breakdown(torch, prof, out_dir / f"profile_serve_{tag}_{name}.txt")
        k1_ms = ms_of("flash_fwd_")
        k4_ms = ms_of("ragged_")
        measured = bool(kernels)
        record = {
            "engine": args.engine,
            "model": args.model,
            "compute_dtype": name,
            "device": smi,
            "tokens": tokens,
            "wall_s": wall_s,
            "tokens_per_s": tokens / wall_s,
            "ttft_ms_p50": stats["ttft_ms"]["p50"],
            "k1_launches": k1_launches,
            "k1_kernel_launches": k1_kernels,
            "k4_launches": k4_launches,
            "k4_kernel_launches": k4_kernels,
            "profiled_wall_ms": prof_wall_s * 1e3,
            "device_kernel_ms": device_ms if measured else "not measured",
            # the profiled pass does the timed pass's work; the profiler slows
            # the host, so the share against the timed pass is the one to read
            "device_busy_share": device_ms / (wall_s * 1e3) if measured else "not measured",
            "device_busy_share_profiled": device_ms / (prof_wall_s * 1e3) if measured else "not measured",
            "k1_device_ms": k1_ms if measured else "not measured",
            "k1_share_of_device": k1_ms / device_ms if device_ms else "not measured",
            "k1_route_device_ms": _k1_routes(ms_of) if measured else "not measured",
            "k1_route_launches": k1_routes,
            "k4_device_ms": k4_ms if measured else "not measured",
            "k4_share_of_device": k4_ms / device_ms if device_ms else "not measured",
            "k4_route_device_ms": _k4_routes(ms_of) if measured else "not measured",
            "k4_route_launches": k4_routes,
            "top_kernels": [
                {"name": e.key[:90], "ms": _device_us(e) / 1e3, "calls": e.count}
                for e in kernels[:8]
            ],
        }
        record.update(do_sample=args.do_sample, num_beams=args.num_beams)
        if args.do_sample:
            sampler_ms = sum(_device_us(e) for e in kernels
                             if any(p in e.key.lower() for p in SAMPLER_PATTERNS)) / 1e3
            steps = steps or stats["decode_steps"]
            record.update(sampler_device_ms=sampler_ms if measured else "not measured",
                          sampler_device_ms_per_step=sampler_ms / steps if measured
                          else "not measured", sampled_steps=steps)
        if args.num_beams > 1:
            record.update(beam_steps=steps, device_ms_per_beam_step=device_ms / steps
                          if measured else "not measured")
        if args.engine == "bucket":
            record["batch_execute_ms"] = engine.samples["device_execute_ms"]
        else:
            record.update(kv_layout=engine.kv_layout, kv_layout_requested=args.kv_layout,
                          kv_autotune=kv_verdict, decode_steps=stats["decode_steps"],
                          boundary_steps=stats["boundary_steps"],
                          decode_step_ms_p50=stats["decode_step_ms"]["p50"],
                          prefill_chunk=args.prefill_chunk, prefill_chunks=stats["prefill_chunks"],
                          prefix_cache=stats.get("prefix_cache"))
            if args.preemption != "off":
                pre = stats["preemption"]
                record.update(kv_blocks=args.kv_blocks, preemption={
                    k: pre[k] for k in ("mode", "preemptions", "readmissions", "swaps",
                                        "swap_restores", "swap_bytes", "by_tier")},
                    swap_out_ms=engine.samples["swap_out_ms"],
                    swap_in_ms=engine.samples["swap_in_ms"],
                    prefills=stats["prefills"],
                    memcpy_device_ms={"dtoh": ms_of("Memcpy DtoH"), "htod": ms_of("Memcpy HtoD")}
                    if measured else "not measured")
            if args.speculation != "off":
                sp = stats["speculation"]
                gemm_ms = sum(_device_us(e) for e in kernels
                              if any(p in e.key.lower() for p in GEMM_PATTERNS)) / 1e3
                record.update(speculation={k: sp[k] for k in (
                    "mode", "k", "draft_layers", "rounds", "proposed", "accepted", "emitted",
                    "acceptance_rate", "tokens_per_round")},
                    k1_launches_per_round=k1_launches / max(1, sp["rounds"]),
                    k1_device_ms_per_round=k1_ms / max(1, sp["rounds"]) if measured
                    else "not measured",
                    gemm_device_ms=gemm_ms if measured else "not measured",
                    gemm_share_of_device=gemm_ms / device_ms if device_ms else "not measured")
        print(json.dumps(record), flush=True)
        del model, engine
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
