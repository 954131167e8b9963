#!/usr/bin/env python3
"""Where the serve (or train) time goes on the card.

    python3 profile_serve.py                                   # bucket engine
    python3 profile_serve.py --engine slots --kv-layout paged  # slot engine
    python3 profile_serve.py --engine train                    # one train step

``--engine bucket`` (default) serves the 8-request workload of
``chip_smoke.py``'s serve phase through ``ServingEngine``; ``--engine
slots`` serves the 12-request workload of its slot-serve phase through
``SlotServingEngine`` (4 slots) in the ``--kv-layout`` given (dense or
paged). Both over the full-width CLM (random weights from a seed) on one
GPU, in fp32 and in bf16 compute. For each: one warm-up pass, one timed pass
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
route (split, wgmma, tf32x3, and simt, which no traffic takes) and its
device kernel launches (a split-route call launches two: partials and
merge), K4's device time, launches and device kernel launches by route
(split, tc, and simt, which no traffic takes; a split-route call launches
two), K2's and K3's device time and launches by route (wgmma, tf32x3,
simt) when training, and the top kernels by device time.
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


def _workload(args, torch, chip_smoke, gen_mod, buckets, slots_mod, engine_mod, vocab_size):
    """``(make_engine, run, tokens)`` for the chosen engine."""
    if args.engine == "bucket":
        table, work = chip_smoke.serve_workload(torch, gen_mod, buckets, vocab_size)

        def make(model):
            return engine_mod.ServingEngine(model, table=table)

        def run(engine):
            for c, prompts in work:
                engine.serve(prompts, c)

        return make, run, sum(c.max_new_tokens * len(p) for c, p in work)

    gcfg, prompts, news = chip_smoke.slot_serve_workload(torch, gen_mod, vocab_size)
    table = buckets.BucketTable(prompt_lens=chip_smoke.SLOT_BUCKETS, batch_sizes=(1,))

    def make(model):
        return slots_mod.SlotServingEngine(model, gcfg, table, slots=4, kv_layout=args.kv_layout)

    def run(engine):
        for p, k in zip(prompts, news):
            engine.submit(p, dataclasses.replace(gcfg, max_new_tokens=k))
        engine.run_until_idle()

    return make, run, sum(news)


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
    ``flash_fwd_split_kernel`` and its merge; no pattern is part of another
    route's name)."""
    return {"simt": ms_of("flash_fwd_kernel"), "wgmma": ms_of("flash_fwd_wgmma_"),
            "tf32x3": ms_of("flash_fwd_tf32x3_"), "split": ms_of("flash_fwd_split_")}


def _k4_routes(ms_of) -> dict:
    """K4's device ms by route (kernel names: ``ragged_decode_kernel`` and
    ``ragged_window_kernel`` simt, ``ragged_split_kernel`` and its merge,
    ``ragged_tc_kernel``)."""
    return {"simt": ms_of("ragged_decode_kernel") + ms_of("ragged_window_kernel"),
            "split": ms_of("ragged_split_"), "tc": ms_of("ragged_tc_")}


def _bwd_routes(ms_of, kernel: str) -> dict:
    """K2's (``kernel`` "dq") or K3's ("dkv") device ms by route (kernel
    names: ``flash_bwd_<kernel>_kernel`` simt, ``flash_bwd_<kernel>_wgmma_kernel``,
    ``flash_bwd_<kernel>_tf32x3_kernel``)."""
    return {"simt": ms_of(f"flash_bwd_{kernel}_kernel"), "wgmma": ms_of(f"flash_bwd_{kernel}_wgmma_kernel"),
            "tf32x3": ms_of(f"flash_bwd_{kernel}_tf32x3_kernel")}


def _profile_train(torch, profile, ProfilerActivity, chip_smoke, clm, flash, dtype, smi, out_dir):
    from perceiver_io_tpu_torch import parallel, training

    name = str(dtype).split(".")[-1]
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
    kernels, device_ms, ms_of = _breakdown(torch, prof, out_dir / f"profile_serve_train_{name}.txt")
    measured = bool(kernels)
    p50 = sorted(step_ms)[1]
    by_kernel = {"k1": ms_of("flash_fwd_"), "k2": sum(_bwd_routes(ms_of, "dq").values()),
                 "k3": sum(_bwd_routes(ms_of, "dkv").values())}
    shares = {}
    for key, ms in by_kernel.items():
        shares[f"{key}_device_ms"] = ms if measured else "not measured"
        shares[f"{key}_share_of_device"] = ms / device_ms if measured else "not measured"
    return {
        "engine": "train", "compute_dtype": name, "device": smi, "step_ms": step_ms,
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


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--engine", choices=("bucket", "slots", "train"), default="bucket")
    parser.add_argument("--kv-layout", choices=("dense", "paged"), default="dense",
                        help="the slot engine's KV layout")
    args = parser.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_serve: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from perceiver_io_tpu_torch.inference import generate as gen_mod
    from perceiver_io_tpu_torch.models.text import clm
    from perceiver_io_tpu_torch.ops import flash_attention as flash
    from perceiver_io_tpu_torch.ops import ragged_attention as ragged
    from perceiver_io_tpu_torch.serving import buckets
    from perceiver_io_tpu_torch.serving import engine as engine_mod
    from perceiver_io_tpu_torch.serving import slots as slots_mod

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    cfg = chip_smoke.clm_base_config(clm.CausalLanguageModelConfig)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    tag = args.engine + (f"_{args.kv_layout}" if args.engine == "slots" else "")

    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        if args.engine == "train":
            print(json.dumps(_profile_train(torch, profile, ProfilerActivity, chip_smoke, clm, flash,
                                            dtype, smi, out_dir)), flush=True)
            torch.cuda.empty_cache()
            continue
        model = clm.CausalLanguageModel(cfg, dtype=dtype, seed=0).eval()
        make, run, tokens = _workload(args, torch, chip_smoke, gen_mod, buckets, slots_mod,
                                      engine_mod, cfg.vocab_size)

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
        if args.engine == "bucket":
            record["batch_execute_ms"] = engine.samples["device_execute_ms"]
        else:
            record.update(kv_layout=args.kv_layout, decode_steps=stats["decode_steps"],
                          boundary_steps=stats["boundary_steps"],
                          decode_step_ms_p50=stats["decode_step_ms"]["p50"])
        print(json.dumps(record), flush=True)
        del model, engine
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
