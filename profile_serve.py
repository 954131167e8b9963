#!/usr/bin/env python3
"""Where the serve time goes on the card.

    python3 profile_serve.py

Serves the 8-request workload of ``chip_smoke.py`` over the full-width CLM
(random weights from a seed) on one GPU, in fp32 and in bf16 compute. For
each: one warm-up pass, one timed pass (host clock around work that ends in
a synchronise), and one pass under ``torch.profiler``. Prints one JSON line
per compute type: tokens/s, the device's busy share (kernel device time of
the profiled pass over the timed pass's wall time, one stream), the flash
attention kernel's share and launches, and the top kernels by device time.
The full profiler tables go to ``chiprun_out/profile_serve_<dtype>.txt``.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def main() -> int:
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
    from perceiver_io_tpu_torch.serving import buckets
    from perceiver_io_tpu_torch.serving import engine as engine_mod

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    cfg = chip_smoke.clm_base_config(clm.CausalLanguageModelConfig)

    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        model = clm.CausalLanguageModel(cfg, dtype=dtype, seed=0).eval()
        table, work = chip_smoke.serve_workload(torch, gen_mod, buckets, cfg.vocab_size)
        tokens = sum(c.max_new_tokens * len(p) for c, p in work)

        def serve_all():
            engine = engine_mod.ServingEngine(model, table=table)
            for c, prompts in work:
                engine.serve(prompts, c)
            torch.cuda.synchronize()
            return engine

        serve_all()  # warm-up
        flash.flash_attention.launches = 0
        t0 = time.perf_counter()
        engine = serve_all()
        wall_s = time.perf_counter() - t0
        launches = flash.flash_attention.launches

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True) as prof:
            t1 = time.perf_counter()
            serve_all()
            prof_wall_s = time.perf_counter() - t1
        events = prof.key_averages()
        kernels = [e for e in events
                   if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
                   and _device_us(e) > 0]
        kernels.sort(key=_device_us, reverse=True)
        device_ms = sum(_device_us(e) for e in kernels) / 1e3
        k1_ms = sum(_device_us(e) for e in kernels if "flash_fwd_kernel" in e.key) / 1e3
        (out_dir / f"profile_serve_{name}.txt").write_text(
            events.table(sort_by="self_cuda_time_total", row_limit=60)
        )
        print(json.dumps({
            "compute_dtype": name,
            "device": torch.cuda.get_device_name(0),
            "tokens": tokens,
            "wall_s": wall_s,
            "tokens_per_s": tokens / wall_s,
            "batch_execute_ms": engine.samples["device_execute_ms"],
            "k1_launches": launches,
            "profiled_wall_ms": prof_wall_s * 1e3,
            "device_kernel_ms": device_ms if kernels else "not measured",
            # the profiled pass does the timed pass's work; the profiler slows
            # the host, so the share against the timed pass is the one to read
            "device_busy_share": device_ms / (wall_s * 1e3) if kernels else "not measured",
            "device_busy_share_profiled": device_ms / (prof_wall_s * 1e3) if kernels else "not measured",
            "k1_device_ms": k1_ms if kernels else "not measured",
            "k1_share_of_device": k1_ms / device_ms if device_ms else "not measured",
            "top_kernels": [
                {"name": e.key[:90], "ms": _device_us(e) / 1e3, "calls": e.count}
                for e in kernels[:8]
            ],
        }), flush=True)
        del model
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
