#!/usr/bin/env python3
"""Device time of K2 and K3 (the flash backward), and with ``--k1`` of K1,
on one GPU, at the training shapes of ``chip_smoke.py``'s ``k23`` phase,
through the route the wrappers pick:

    python3 time_k23.py                       # fp32 (route tf32x3)
    python3 time_k23.py --dtype bfloat16      # route wgmma
    python3 time_k23.py --head-dims 96 112    # only the cases of these q/k head dims
    python3 time_k23.py --classifiers --k1 --dtype float32 bfloat16
    python3 time_k23.py build/a build/b build/b build/a --classifiers

The cases are ``K23_CASES`` and ``K23_NONCAUSAL_CASES`` (b = 4, h = 8), or
with ``--classifiers`` ``K23_CLASSIFIER_CASES``, each with its own b and h:
(160, 160) on the tile routes and the pairs outside ``HEAD_DIMS`` on
``wide`` (K1) and ``wide_mma`` (K2/K3).

Prints the card (``nvidia-smi`` name and power limit) as a JSON line, then
one JSON line per case and type: the median over ``--reps`` readings of
``chip_smoke.device_ms`` (``--iters`` launches behind a sleep kernel, over
input copies that fill the L2 twice; a tenth of them at 50176 keys or more)
of each kernel, with K1's largest error against its plain version; then
the ``ptxas`` registers and spill-store bytes of each kernel it built.
K2/K3's outputs are not checked here: ``chip_smoke.py`` holds them against
the plain versions.

To compare two versions of the kernels, give their checkout roots in the
order A B B A: each runs its own copy of this script in a process of its
own, and builds its own kernels from its sources under its own
``build/kernels``.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path


def run_checkout(args) -> int:
    import torch

    import chip_smoke as cs
    from perceiver_io_tpu_torch import _build
    from perceiver_io_tpu_torch.ops import flash_attention as flash

    torch.backends.cuda.matmul.allow_tf32 = False
    print(json.dumps({"source": str(cs.ROOT)}), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(5)
    if args.classifiers:
        shapes = list(cs.K23_CLASSIFIER_CASES)
    else:
        shapes = [(name, i, j, pads, None, d, d, True, 4, 8) for name, i, j, pads, d in cs.K23_CASES] + [
            (*c, False, 4, 8) for c in cs.K23_NONCAUSAL_CASES]
    for name, i, j, pads, visible, d, dv, causal, b, h in shapes:
        if args.head_dims and d not in args.head_dims:
            continue
        pad, _ = cs.case_mask(torch, i, j, pads, visible, causal, b)
        kw = dict(pad_mask=pad, causal=causal)
        iters = max(1, args.iters // 10) if j >= 50176 else args.iters
        for tname in args.dtype:
            dtype = getattr(torch, tname)
            q = (torch.randn(b, h, i, d, generator=gen, device="cuda") * d**-0.5).to(dtype)
            k = torch.randn(b, h, j, d, generator=gen, device="cuda").to(dtype)
            v = torch.randn(b, h, j, dv, generator=gen, device="cuda").to(dtype)
            do = torch.randn(b, h, i, dv, generator=gen, device="cuda").to(dtype)
            o, lse = flash.flash_attention_fwd(q, k, v, **kw)
            delta = flash.attention_delta(o, do)
            row = dict(case=name, b=b, h=h, i=i, j=j, d=d, dv=dv, causal=causal, dtype=tname,
                       route=flash._bwd_route(dtype, d, dv), reps=args.reps, iters=iters)
            kernels = {"dq": lambda *t: flash.flash_attention_bwd_dq(*t, **kw),
                       "dkv": lambda *t: flash.flash_attention_bwd_dkv(*t, **kw)}
            if args.k1:
                o_ref, _ = flash.flash_attention_reference(q, k, v, **kw)
                row.update(k1_route=flash._fwd_route(i, dtype, d, dv),
                           k1_max_abs_err=(o.float() - o_ref.float()).abs().max().item())
                del o_ref
                kernels = {"k1": lambda q, k, v, *_: flash.flash_attention_fwd(q, k, v, **kw), **kernels}
            for kname, fn in kernels.items():
                timed, _ = cs.l2_cold(fn, q, k, v, lse, delta, do)
                readings = [cs.device_ms(timed, iters) for _ in range(args.reps)]
                row[f"{kname}_ms"] = statistics.median(readings)
                row[f"{kname}_ms_readings"] = readings
            print(json.dumps(row), flush=True)
            del q, k, v, do, o, lse, delta
            torch.cuda.empty_cache()
    print(json.dumps({"ptxas": {
        lib: {kernel: [rec["registers"], rec["max_spill_store_bytes"]] for kernel, rec in cs.ptxas_by_kernel(log).items()}
        for lib, log in _build.BUILD_LOG.items()}}), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("checkouts", nargs="*", help="checkout roots to time in turn (default: this one)")
    ap.add_argument("--dtype", nargs="+", default=["float32"], choices=("float32", "bfloat16"))
    ap.add_argument("--head-dims", type=int, nargs="*", help="q/k head dims to keep (default: all cases)")
    ap.add_argument("--classifiers", action="store_true", help="time K23_CLASSIFIER_CASES")
    ap.add_argument("--k1", action="store_true", help="time K1 (the forward) as well")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--iters", type=int, default=30)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("time_k23: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"card": smi}), flush=True)
    if not args.checkouts:
        return run_checkout(args)
    flags = ["--dtype", *args.dtype, f"--reps={args.reps}", f"--iters={args.iters}"]
    flags += ["--head-dims", *map(str, args.head_dims)] if args.head_dims else []
    flags += ["--classifiers"] * args.classifiers + ["--k1"] * args.k1
    for root in (Path(r).resolve() for r in args.checkouts):
        # the checkout's own copy of this script and of the package
        if subprocess.run([sys.executable, str(root / "time_k23.py"), *flags], cwd=root).returncode != 0:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
