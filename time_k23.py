#!/usr/bin/env python3
"""Device time of K2 and K3 (the flash backward) on one GPU, at the training
shapes of ``chip_smoke.py``'s ``k23`` phase (``K23_CASES`` and
``K23_NONCAUSAL_CASES``, b = 4, h = 8), through the route the type picks:

    python3 time_k23.py                      # fp32 (route tf32x3)
    python3 time_k23.py --dtype bfloat16     # route wgmma
    python3 time_k23.py --head-dims 96 112   # only the cases of these q/k head dims

Prints the card (``nvidia-smi`` name and power limit) as a JSON line, then
one JSON line per case: the median over ``--reps`` readings of
``chip_smoke.device_ms`` (``--iters`` launches behind a sleep kernel, over
input copies that fill the L2 twice) of each kernel. Outputs are not
checked here: ``chip_smoke.py`` holds them against the plain versions.

To compare two versions of the kernels, run this script from two checkouts
in one session on the card, in the order A B B A: each checkout builds its
own kernels from its sources.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys

import chip_smoke as cs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dtype", default="float32", choices=("float32", "bfloat16"))
    ap.add_argument("--head-dims", type=int, nargs="*", help="q/k head dims to keep (default: all cases)")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--iters", type=int, default=30)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("time_k23: no CUDA device", file=sys.stderr)
        return 1
    from perceiver_io_tpu_torch.ops import flash_attention as flash

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"card": smi, "source": str(cs.ROOT)}), flush=True)
    dtype = getattr(torch, args.dtype)
    gen = torch.Generator(device="cuda").manual_seed(5)
    b, h = 4, 8
    shapes = [(name, i, j, pads, None, d, d, True) for name, i, j, pads, d in cs.K23_CASES] + [
        (*c, False) for c in cs.K23_NONCAUSAL_CASES]
    for name, i, j, pads, visible, d, dv, causal in shapes:
        if args.head_dims and d not in args.head_dims:
            continue
        pad, _ = cs.case_mask(torch, i, j, pads, visible, causal, b)
        q = (torch.randn(b, h, i, d, generator=gen, device="cuda") * d**-0.5).to(dtype)
        k = torch.randn(b, h, j, d, generator=gen, device="cuda").to(dtype)
        v = torch.randn(b, h, j, dv, generator=gen, device="cuda").to(dtype)
        do = torch.randn(b, h, i, dv, generator=gen, device="cuda").to(dtype)
        kw = dict(pad_mask=pad, causal=causal)
        o, lse = flash.flash_attention_fwd(q, k, v, **kw)
        delta = flash.attention_delta(o, do)
        row = dict(case=name, i=i, j=j, d=d, dv=dv, causal=causal, dtype=args.dtype,
                   route=flash._bwd_route(dtype), reps=args.reps, iters=args.iters)
        for kname, fn in (("dq", flash.flash_attention_bwd_dq), ("dkv", flash.flash_attention_bwd_dkv)):
            timed, _ = cs.l2_cold(lambda *t, f=fn: f(*t, **kw), q, k, v, lse, delta, do)
            readings = [cs.device_ms(timed, args.iters) for _ in range(args.reps)]
            row[f"{kname}_ms"] = statistics.median(readings)
            row[f"{kname}_ms_readings"] = readings
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
