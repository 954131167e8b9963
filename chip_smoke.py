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
   j = 612, and a decode attend whose lengths leave whole key splits masked
   and one row dead; every case but the ragged one again at head dims 64
   and 128, timed over fewer iterations), fp32 and bf16, through the route
   the wrapper picks (``split`` for decode, ``wgmma`` for bf16 tiles,
   ``tf32x3`` for fp32 tiles; a wrong route fails), held at fp32 1e-4, bf16
   2e-2 and lse 1e-3 on live rows, dead rows exactly 0 with ``lse`` the
   mask value. The first CUDA-core kernel (simt) runs on the same inputs,
   is held to the same gates and is timed beside it (``prev_ms``), with the plain
   version's time, ``scaled_dot_product_attention``'s with its backend
   pinned to memory-efficient attention (a yardstick the port never calls)
   and the card's bound (here and in phase 8 its bytes count k and v only
   for the keys some query row sees, as K4's count only live keys; for
   ``tf32x3`` cases ``bound_ms`` at a third of the TF32 tensor-core rate and
   ``bound_simt_ms`` at the CUDA cores' rate, as in phase 8). Then each of
   the split, wgmma and tf32x3 routes must refuse a query on a base off a
   16-byte boundary (``ValueError``, no launch counted). Every timed loop
   here and in phases 6 and 8 reads the next of enough input copies to fill
   the L2 twice, so its times are HBM times, as the bound is, and queues
   behind a sleep kernel, so they are the card's times without the host's
   dispatch (``device_ms``);
4. model: the full-width C4 CLM ("clm-base": vocab 32000, 1024 context, 512
   latents, 896 channels, 8 heads, 16 layers; random weights from a seed),
   one forward with the kernel against ``attention_impl="xla"``, fp32 and
   bf16 compute; and a small model's greedy tokens on the card against the
   same model on the CPU;
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
   idle and one of 40 keys, whose first 60 queries see nothing) and the
   slot engine's window step (4 rows, q_len 512, lengths 520..1024, one
   idle); the decode and window cases again at head dims 64 and 128, timed
   over fewer iterations. Each in fp32, bf16 and int8 with scales, through
   the route the wrapper picks (``split`` for decode rows, ``tc`` for
   window rows; a wrong route fails), held at 4e-3 in bf16 and 1e-4
   otherwise, idle rows and dead queries exactly 0, every output finite.
   The first CUDA-core kernel (simt) runs on the same inputs, is held to
   the same gates and is timed beside it (``prev_ms``). With the plain
   version's time, the gather reference plus
   ``scaled_dot_product_attention`` (``gather_sdpa_ms``, a yardstick the
   port never calls) and the card's bound (window cases: fp32 and int8 at a
   third of the TF32 tensor-core rate, bf16 at the bf16 rate, and
   ``bound_simt_ms`` at the CUDA cores' rate). No single PyTorch call reads
   a block table, so ``library_ms`` is null. Then the split and tc routes
   must each refuse a query and a pool on a base off a 16-byte boundary
   (``ValueError``, no launch counted);
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
8. k23: the flash-attention backward kernels, K2 (dq) and K3 (dk, dv),
   against their plain versions at the training path's shapes (b = 4, 8
   heads, head dim 112; the cross attends over j = 768, 256 kept prefix +
   512 latents, and j = 1024, with left pads that leave dead rows; the
   latent stack at j = 512 with no pad mask, also at head dims 64 and 128;
   ragged tiles i = 100 over j = 300 with pads), fp32 and bf16, through the
   route the wrappers pick (``wgmma`` for bf16, ``tf32x3`` for fp32; a
   wrong route fails), held at ``max|d| <= tol * max|plain|`` per output,
   tol 1e-4 in fp32 and 2^-7 (two bf16 ulps) in bf16, where each bf16
   output's error against the fp32 plain backward of the same inputs must
   also stay within 1.5x the plain bf16 version's; dead rows' dq and unseen
   keys' dk/dv must be exactly 0 and every output finite. With each
   kernel's time, the ``simt`` kernel's on the same inputs (``prev_ms``: the
   CUDA-core design both types took first), the plain version's, the
   backward alone of ``scaled_dot_product_attention`` (its memory-efficient
   backend pinned; a yardstick the port never calls) and the card's bound
   (in fp32 ``bound_ms`` at a third of the TF32 tensor-core rate, the most
   the ``tf32x3`` route's three products per fp32 product can reach, and
   ``bound_simt_ms`` at the CUDA cores' rate, as the simt route's rows). The
   ``simt`` kernels' outputs are held to 1e-4 of each output's largest plain
   entry in both types (``prev_rel_err``), with the same zeros and finite
   values, before they are timed;
9. train, over the full-width CLM:
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
10. the ``{"kernels": [...]}`` summary line (K1 with the three routes the
   main path runs nested, the simt kernel's times as their ``prev_ms``, an
   entry for each of K2's and K3's routes that the main path runs, K4 with
   its split and tc routes nested and the simt kernel's times as their
   ``prev_ms``; K1's and K4's ``launches`` count their wrappers' calls and
   their ``kernel_launches`` the device kernels, two per split-route
   call), the card's
   ``nvidia-smi`` line, and the final ``{"ok": true, ...}`` line.

fp32 comparisons run with TF32 off (``torch.backends.cuda.matmul.allow_tf32``
and ``torch.backends.cudnn.allow_tf32`` set False).
"""
from __future__ import annotations

import itertools
import json
import math
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

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
# the simt K2/K3 kernels, timed beside each route as prev_ms, are held to
# 1e-4 in both types, the bar they had when they were the routes
SIMT_REL_TOL = 1e-4
# K2/K3's cases: (name, i, j, left pads per batch row or None, head dim), b = 4
K23_CASES = (
    ("cross", 512, 768, [0, 100, 300, 600], 112),   # 256 kept prefix + 512 latents; row 3's rows 0..343 dead
    ("cross", 512, 1024, [0, 100, 600, 900], 112),  # the whole prefix; row 3's rows 0..387 dead
    ("stack", 512, 512, None, 112),                 # the latent stack: no pad mask, as on the main path
    ("ragged", 100, 300, [0, 30, 150, 260], 112),   # ragged q and kv tiles; row 3's rows 0..59 dead
    ("stack", 512, 512, None, 64),                  # the kernels' other two head dims
    ("stack", 512, 512, None, 128),
)
L2_BYTES = 50 * 2**20  # H100 SXM
# the slot-serve phase's prompt buckets: (512, 768, 1024) would make prompts
# past 768 infeasible with 496 latents (a 1024 bucket leaves 528 prefix slots
# > max_prefix_len 512), so the top bucket is 1008 = 512 + 496
SLOT_BUCKETS = (512, 768, 1008)
NEAR_TIE = 1e-4
TRAIN_STEPS = 8


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


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


def l2_cold(fn, *tensors):
    """``(call, copies)``: ``call()`` runs ``fn`` on the next of enough
    copies of ``tensors`` to fill the L2 twice, so a timed loop of it reads
    its inputs from HBM, as the bound counts them."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    copies = [tensors] + [
        tuple(t.clone() for t in tensors) for _ in range(max(2, math.ceil(2 * L2_BYTES / nbytes)) - 1)
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
)
K1_HEAD_DIM = 112  # clm-base: 896 channels over 8 heads
# the kernels' other head dims, each case but the ragged one, timed over
# fewer iterations
K1_OTHER_HEAD_DIMS = (64, 128)
K1_OTHER_CASES = ("cross", "stack", "decode", "decode_empty")


def k1_expected_route(name: str, tname: str) -> str:
    return "split" if name.startswith("decode") else ("wgmma" if tname == "bfloat16" else "tf32x3")


SDPA_BACKEND = "EFFICIENT_ATTENTION"


def sdpa_backend():
    """A context that pins the library yardstick's backend: memory-efficient
    attention, which takes a boolean mask in fp32 and bf16 (a call it
    refuses raises instead of moving to another backend)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    return sdpa_kernel(getattr(SDPBackend, SDPA_BACKEND))


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
    the route the wrapper picks, beside PR 1's simt kernel on the same
    inputs (``prev_ms``), itself held to the same gates; at head dim 112 and
    at the kernels' other head dims."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(0)
    b, h = 4, 8
    shapes = [(*c, K1_HEAD_DIM) for c in K1_CASES] + [
        (*c, d) for d in K1_OTHER_HEAD_DIMS for c in K1_CASES if c[0] in K1_OTHER_CASES]
    cases = []
    for name, i, j, pads, visible, d in shapes:
        cols = torch.arange(j, device="cuda")[None, :]
        if pads is not None:
            pad = cols < torch.tensor(pads, device="cuda")[:, None]
        else:
            pad = cols >= torch.tensor(visible, device="cuda")[:, None]
        causal_ok = cols <= torch.arange(i, device="cuda")[:, None] + (j - i)
        allowed = causal_ok[None] & ~pad[:, None, :]  # (b, i, j)
        live = allowed.any(-1)  # (b, i)
        seen = int(allowed.any(1).sum().item())  # keys some row sees: the only k/v rows read
        pairs = int(allowed.sum().item()) * h
        main_dim = d == K1_HEAD_DIM
        for dtype in (torch.float32, torch.bfloat16):
            tname = str(dtype).split(".")[-1]
            q = (torch.randn(b, h, i, d, generator=gen, device="cuda") * d**-0.5).to(dtype)
            k = torch.randn(b, h, j, d, generator=gen, device="cuda").to(dtype)
            v = torch.randn(b, h, j, d, generator=gen, device="cuda").to(dtype)
            before = dict(flash.flash_attention.route_launches)
            o, lse = flash.flash_attention_fwd(q, k, v, pad_mask=pad, causal=True)
            route = next(r for r, n in flash.flash_attention.route_launches.items() if n != before[r])
            o_prev, lse_prev = flash._fwd_launch("simt", q, k, v, pad, True)
            o_ref, lse_ref = flash.flash_attention_reference(q, k, v, pad_mask=pad, causal=True)
            torch.cuda.synchronize()
            err, lse_err, dead_zero = _k1_errors(flash, o, lse, o_ref, lse_ref, live)
            prev_err, prev_lse_err, prev_dead_zero = _k1_errors(flash, o_prev, lse_prev, o_ref, lse_ref, live)
            del o_prev, lse_prev
            tol = KERNEL_TOL[tname]
            expected = k1_expected_route(name, tname)
            if not (err <= tol and lse_err <= 1e-3 and dead_zero and route == expected):
                raise AssertionError(
                    f"K1 {name} d={d} {tname} ({route}, expected {expected}): max|d| {err} (tol {tol}), "
                    f"lse {lse_err}, dead rows 0 with lse MASK {dead_zero}"
                )
            if not (prev_err <= tol and prev_lse_err <= 1e-3 and prev_dead_zero):
                raise AssertionError(
                    f"K1 simt (prev_ms) {name} d={d} {tname}: max|d| {prev_err} (tol {tol}), "
                    f"lse {prev_lse_err}, dead rows 0 with lse MASK {prev_dead_zero}"
                )
            iters = (100 if i > 1 else 200) if main_dim else (30 if i > 1 else 50)
            attn_mask = allowed[:, None]
            kernel, copies = l2_cold(
                lambda q, k, v: flash.flash_attention_fwd(q, k, v, pad_mask=pad, causal=True), q, k, v)
            prev, _ = l2_cold(lambda q, k, v: flash._fwd_launch("simt", q, k, v, pad, True), q, k, v)
            plain, _ = l2_cold(
                lambda q, k, v: flash.flash_attention_reference(q, k, v, pad_mask=pad, causal=True),
                q, k, v)
            library, _ = l2_cold(
                lambda q, k, v: F.scaled_dot_product_attention(q, k, v, attn_mask=attn_mask, scale=1.0),
                q, k, v)
            ms = device_ms(kernel, iters)
            prev_ms = device_ms(prev, iters)
            plain_ms = device_ms(plain, 10 if main_dim else 3)
            with sdpa_backend():
                library_ms = device_ms(library, iters)
            del kernel, prev, plain, library
            esize = q.element_size()
            nbytes = ((q.numel() + o.numel() + 2 * seen * h * d) * esize + lse.numel() * 4
                      + pad.numel())
            flops = 4 * d * pairs  # q.k and p.v over the keys this data lets each row see
            bytes_s, ops_s = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[tname]
            case = dict(
                case=name, dtype=tname, route=route, b=b, h=h, i=i, j=j, d=d, max_abs_err=err,
                tol=tol, lse_max_abs_err=lse_err, dead_rows=int((~live).sum().item()),
                dead_rows_zero_lse_mask=dead_zero, ms=ms, prev_ms=prev_ms, prev_route="simt",
                prev_max_abs_err=prev_err, prev_lse_max_abs_err=prev_lse_err,
                plain_ms=plain_ms, library_ms=library_ms, library_backend=SDPA_BACKEND,
                input_copies=copies, iters=iters,
            )
            if route == "tf32x3":
                # the card's fp32-accurate rate is the tensor cores' TF32 rate
                # over three; the CUDA cores' bound stays beside it so rows
                # compare with those of the simt route
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
    16-byte boundary: the wrapper raises ``ValueError`` and counts no
    launch."""
    d = K1_HEAD_DIM
    seen = {}
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
        seen[route] = dict(picked=flash._fwd_route(i, dtype), message=message, counted=counted)
    emit("k1_refusal", routes=seen)
    for route, r in seen.items():
        if r["picked"] != route or r["message"] is None or "16-byte" not in r["message"] or r["counted"]:
            raise AssertionError(f"K1 {route} did not refuse a misaligned query: {r}")


def _grad_rotation(torch, F, q, k, v, do, attn_mask):
    """``(call, copies)``: ``call()`` runs the backward alone of
    ``scaled_dot_product_attention`` (its memory-efficient backend, pinned)
    on the next of enough kept graphs (input copies) to fill the L2 twice:
    the library yardstick of K2 and K3."""
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, do))
    graphs = []
    for _ in range(max(2, math.ceil(2 * L2_BYTES / nbytes))):
        qq, kk, vv = (t.detach().clone().requires_grad_() for t in (q, k, v))
        with sdpa_backend():
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
    ``simt`` kernels on the same inputs (``prev_ms``): dead rows' dq and padded
    keys' dk/dv exactly 0; bf16 also against the fp32 oracle."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(5)
    b, h = 4, 8
    wrappers = {"dq": flash.flash_attention_bwd_dq, "dkv": flash.flash_attention_bwd_dkv}
    cases = []
    for name, i, j, pads, d in K23_CASES:
        cols = torch.arange(j, device="cuda")[None, :]
        pad = None if pads is None else cols < torch.tensor(pads, device="cuda")[:, None]
        allowed = (cols <= torch.arange(i, device="cuda")[:, None] + (j - i))[None].expand(b, i, j)
        if pad is not None:
            allowed = allowed & ~pad[:, None, :]
        live = allowed.any(-1)  # (b, i) rows that see a key
        seen = allowed.any(1)   # (b, j) keys that some row sees
        pairs = int(allowed.sum().item()) * h
        for dtype in (torch.float32, torch.bfloat16):
            tname = str(dtype).split(".")[-1]
            q = (torch.randn(b, h, i, d, generator=gen, device="cuda") * d**-0.5).to(dtype)
            k = torch.randn(b, h, j, d, generator=gen, device="cuda").to(dtype)
            v = torch.randn(b, h, j, d, generator=gen, device="cuda").to(dtype)
            do = torch.randn(b, h, i, d, generator=gen, device="cuda").to(dtype)
            o, lse = flash.flash_attention_fwd(q, k, v, pad_mask=pad, causal=True)
            delta = flash.attention_delta(o, do)
            kw = dict(pad_mask=pad, causal=True)
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
            oracle = {}
            if dtype == torch.bfloat16:
                q32, k32, v32, do32 = (t.float() for t in (q, k, v, do))
                o32, lse32 = flash.flash_attention_reference(q32, k32, v32, **kw)
                exact = flash.flash_attention_backward_reference(q32, k32, v32, o32, lse32, do32, **kw)
                for gname, got, plain, want in zip(("dq", "dk", "dv"), (dq, dk, dv), ref, exact):
                    kernel_err = (got.float() - want).abs().max().item()
                    plain_err = (plain.float() - want).abs().max().item()
                    oracle[gname] = dict(kernel=kernel_err, plain=plain_err,
                                         ratio=kernel_err / plain_err if plain_err > 0 else math.inf)
                del q32, k32, v32, do32, o32, lse32, exact
            dead_zero = bool((dq[~live[:, None, :, None].expand_as(dq)] == 0).all().item())
            unseen = ~seen[:, None, :, None].expand_as(dk)
            unseen_zero = bool((dk[unseen] == 0).all().item() and (dv[unseen] == 0).all().item())
            finite = all(bool(torch.isfinite(t).all().item()) for t in (dq, dk, dv))
            tol, expected = K23_REL_TOL[tname], K23_ROUTE[tname]
            case = dict(case=name, dtype=tname, route=routes, expected_route=expected, b=b, h=h, i=i,
                        j=j, d=d, max_abs_err=errs, rel_err=rel, rel_tol=tol, oracle_err=oracle,
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
            # the simt kernels time prev_ms below: they are held first to the
            # bar they had as the fp32 route (and as the bf16 one before the
            # wgmma route), 1e-4 of each output's largest plain entry
            t6 = (q, k, v, lse, delta, do)
            pdq, pdk, pdv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
            flash._bwd_launch("simt", *t6, pad, True, 0, (pdq,))
            flash._bwd_launch("simt", *t6, pad, True, 1, (pdk, pdv))
            torch.cuda.synchronize()
            prev_rel = {gname: (got.float() - want.float()).abs().max().item() / want.float().abs().max().item()
                        for gname, got, want in zip(("dq", "dk", "dv"), (pdq, pdk, pdv), ref)}
            prev_ok = (max(prev_rel.values()) <= SIMT_REL_TOL
                       and all(bool(torch.isfinite(t).all().item()) for t in (pdq, pdk, pdv))
                       and bool((pdq[~live[:, None, :, None].expand_as(pdq)] == 0).all().item())
                       and bool((pdk[unseen] == 0).all().item() and (pdv[unseen] == 0).all().item()))
            case.update(prev_route="simt", prev_rel_err=prev_rel, prev_rel_tol=SIMT_REL_TOL)
            del pdq, pdk, pdv
            if not prev_ok:
                emit("k23", **case)
                raise AssertionError(f"K2/K3 simt {name} i={i} j={j} {tname}: rel err {prev_rel} "
                                     f"(tol {SIMT_REL_TOL}), or an output not finite, or a dead "
                                     f"row's dq or an unseen key's dk/dv not 0")
            esize = q.element_size()
            pad_bytes = 0 if pad is None else pad.numel()
            kv_read = 2 * int(seen.sum().item()) * h * d * esize  # k and v of the keys some row sees
            times = {}
            for kname, which, kernel, plain, nbytes, flops in (
                ("dq", 0, flash.flash_attention_bwd_dq, flash.flash_attention_bwd_dq_reference,
                 b * h * (3 * i * d * esize + 8 * i) + kv_read + pad_bytes, 6 * d * pairs),
                ("dkv", 1, flash.flash_attention_bwd_dkv, flash.flash_attention_bwd_dkv_reference,
                 b * h * ((2 * i + 2 * j) * d * esize + 8 * i) + kv_read + pad_bytes, 8 * d * pairs),
            ):
                timed, copies = l2_cold(lambda *t, f=kernel: f(*t, **kw), q, k, v, lse, delta, do)
                ms = device_ms(timed, 30)
                outs = (lambda t: (torch.empty_like(t[0]),)) if which == 0 else (
                    lambda t: (torch.empty_like(t[1]), torch.empty_like(t[2])))
                prev, _ = l2_cold(
                    lambda *t, w=which, outs=outs: flash._bwd_launch("simt", *t, pad, True, w, outs(t)),
                    q, k, v, lse, delta, do)
                prev_ms = device_ms(prev, 30)
                plain_ms = device_ms(l2_cold(lambda *t, f=plain: f(*t, **kw), q, k, v, lse, delta, do)[0], 5)
                bytes_s, ops_s = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[tname]
                times[kname] = dict(route=expected, ms=ms, prev_ms=prev_ms, prev_route="simt",
                                    plain_ms=plain_ms, bytes=nbytes, flops=flops, input_copies=copies)
                if expected == "tf32x3":
                    # the card's fp32-accurate rate is the tensor cores' TF32
                    # rate over three; the CUDA cores' bound stays beside it
                    # so rows compare with those of the simt route
                    times[kname].update(bound_simt_ms=max(bytes_s, ops_s) * 1e3,
                                        bound_simt_by="bytes" if bytes_s >= ops_s else "operations")
                    ops_s = 3 * flops / TF32_FLOPS
                times[kname].update(bound_ms=max(bytes_s, ops_s) * 1e3,
                                    bound_by="bytes" if bytes_s >= ops_s else "operations")
                del timed, prev
            attn_mask = allowed[:, None]
            library, graphs = _grad_rotation(torch, F, q, k, v, do, attn_mask)
            library_ms = device_ms(library, 20)
            del library
            torch.cuda.empty_cache()
            case.update(kernels=times, library_ms=library_ms, library_graphs=graphs,
                        library_backend=SDPA_BACKEND,
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


def model_phase(torch, clm, flash, gen_mod):
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


def serve_phase(torch, clm, flash, gen_mod, engine_mod, buckets):
    cfg = clm_base_config(clm.CausalLanguageModelConfig)
    model = clm.CausalLanguageModel(cfg, dtype=torch.float32, seed=0).eval()
    table, work = serve_workload(torch, gen_mod, buckets, cfg.vocab_size)
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
    stats = engine.stats()
    mismatches = 0
    for (c, prompts), rows in zip(work, served):
        for p, row in zip(prompts, rows):
            alone = gen_mod.generate(model, p[None], c)[0].cpu().numpy()
            mismatches += int((alone != row).any())
    emit("serve", requests=stats["completed"], tokens=tokens, wall_s=wall_s,
         tokens_per_s=tokens / wall_s, ttft_ms_p50=stats["ttft_ms"]["p50"],
         device_execute_ms=engine.samples["device_execute_ms"], batches=stats["batches"],
         k1_launches=launches, k1_launches_per_token=launches / tokens, k1_route_launches=routes,
         k1_kernel_launches=kernel_launches, per_request_generate_mismatches=mismatches, compute_dtype="float32")
    # fp32 serving runs K1's split route (decode attends) and tf32x3 route
    # (prefill), never simt
    if (stats["completed"] != 8 or not (routes["split"] > 0 and routes["tf32x3"] > 0)
            or routes["simt"] or mismatches):
        raise AssertionError(f"serve: completed {stats['completed']}, K1 launches {routes}, "
                             f"mismatching requests {mismatches}")
    return launches, routes, kernel_launches


# K4's cases: (name, q_len, lengths), block size 16, 64 pages a row
K4_CASES = (
    ("decode", 1, [1023, 700, 300, 40, 1, 0, 512, 17]),          # tail pages unmapped; row 5 idle
    ("decode7", 7, [1023, 700, 300, 5, 1, 0, 512, 17]),          # 7 queries a row (split takes <= 16):
                                                                  # rows 3 and 4 shorter (8 dead queries)
    ("window", 512, [520, 600, 680, 760, 840, 920, 1000, 1024]),
    ("ragged", 100, [100, 250, 612, 40, 0, 333, 1000, 164]),      # ragged query tiles; row 3 shorter
                                                                  # than q_len (queries 0..59 dead), row 4 idle
    ("slot", 512, [1024, 777, 520, 0]),                           # the slot engine's window step: 4 slots
)
# the kernels' other head dims: the decode and window cases
K4_OTHER_CASES = ("decode", "window")


def k4_expected_route(q_len: int) -> str:
    return "split" if q_len <= 16 else "tc"


def k4_cases(torch, ragged, paged):
    """K4 against its plain version at clm-base's shapes (module docstring),
    through the route the wrapper picks, beside the first (simt) kernel on
    the same inputs (``prev_ms``), itself held to the same gates."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(2)
    h, bs, pages = 8, 16, 64
    shapes = [(*c, K1_HEAD_DIM) for c in K4_CASES] + [
        (*c, d) for d in K1_OTHER_HEAD_DIMS for c in K4_CASES if c[0] in K4_OTHER_CASES]
    cases = []
    for name, q_len, lengths, d in shapes:
        main_dim = d == K1_HEAD_DIM
        b = len(lengths)
        lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        used = [-(-length // bs) for length in lengths]
        blocks = (torch.randperm(sum(used), generator=gen, device="cuda") + 1).int()
        table = torch.zeros(b, pages, dtype=torch.int32, device="cuda")  # tail pages: null block
        start = 0
        for r, u in enumerate(used):
            table[r, :u] = blocks[start:start + u]
            start += u
        tokens = (sum(used) + 1) * bs
        pk = torch.randn(tokens, h, d, generator=gen, device="cuda")
        pv = torch.randn(tokens, h, d, generator=gen, device="cuda")
        pk[:bs], pv[:bs] = 1e3, -1e3  # trash in the null block
        pos = torch.arange(pages * bs, device="cuda")
        qi = torch.arange(q_len, device="cuda")[:, None]
        visible = (pos[None, :] + (q_len - 1) - qi)[None] < lens.long()[:, None, None]  # (b, q, n)
        live = visible.any(-1)[:, None, :, None]  # (b, 1, q, 1): queries that see a key
        pairs = int(visible.sum().item()) * h
        n_live = sum(min(max(length, 0), pages * bs) for length in lengths)  # keys K4 must read
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
            o_prev, ref = prev(*pool), plain(*pool)
            torch.cuda.synchronize()
            tol = K4_TOL[layout]
            checks = {}
            for who, out in (("kernel", o), ("prev", o_prev)):
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
            cold_kernel, copies = l2_cold(kernel, *pool)
            ms = device_ms(cold_kernel, iters)
            prev_ms = device_ms(l2_cold(prev, *pool)[0], iters)
            plain_ms = device_ms(l2_cold(plain, *pool)[0], 10 if main_dim else 3)
            gather_sdpa_ms = device_ms(l2_cold(gather_sdpa, *pool)[0], iters)
            del cold_kernel
            int8 = len(pool) == 4
            nbytes = (2 * q.numel() * q.element_size() + 2 * n_live * h * d * pool[0].element_size()
                      + (2 * n_live * h * 4 if int8 else 0) + table.numel() * 4 + lens.numel() * 4)
            flops = 4 * d * pairs  # q.k and p.v over the (query, key) pairs this data makes visible
            tname = str(dtype).split(".")[-1]  # the products run in q's type
            bytes_s, ops_s = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[tname]
            case = dict(
                case=name, layout=layout, route=route, b=b, h=h, q_len=q_len, d=d, block_size=bs,
                lengths=lengths, max_abs_err=checks["kernel"]["err"], tol=tol,
                idle_rows_dead_queries_zero=checks["kernel"]["dead_zero"],
                dead_queries=int((~live).sum().item()),
                ms=ms, prev_ms=prev_ms, prev_route="simt", prev_max_abs_err=checks["prev"]["err"],
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
    launch."""
    d, bs = K1_HEAD_DIM, 16
    table = torch.tensor([[1, 2]], dtype=torch.int32, device="cuda")
    lengths = torch.tensor([20], dtype=torch.int32, device="cuda")
    seen = {}

    def counts():
        return ragged.ragged_paged_attention.launches, dict(ragged.ragged_paged_attention.route_launches)

    for route, q_len, dtype in (("split", 1, torch.float32), ("tc", 64, torch.bfloat16)):
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
            seen[f"{route} {what}"] = dict(picked=ragged._k4_route(q_len, dtype), message=message,
                                           counted=counts() != before)
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
    window = torch.zeros((1, n), dtype=torch.long, device="cuda")
    window[0, n - len(ctx):] = torch.tensor(ctx, device="cuda")
    pad = torch.tensor([n - len(ctx)], device="cuda")
    with torch.no_grad():
        logits = gen_mod._decode_forward(model, window, pad, min(cfg.num_latents + t, max_latents))
    top = logits[0].float().topk(2).values
    return (top[0] - top[1]).item()


def slot_serve_phase(torch, clm, flash, ragged, gen_mod, slots_mod, buckets):
    import dataclasses

    cfg = clm_base_config(clm.CausalLanguageModelConfig)
    model = clm.CausalLanguageModel(cfg, dtype=torch.float32, seed=0).eval()
    gcfg, prompts, news = slot_serve_workload(torch, gen_mod, cfg.vocab_size)
    configs = [dataclasses.replace(gcfg, max_new_tokens=k) for k in news]
    table = buckets.BucketTable(prompt_lens=SLOT_BUCKETS, batch_sizes=(1,))
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
        engine.run_until_idle()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        k1, k4 = flash.flash_attention.launches, ragged.ragged_paged_attention.launches
        k4_routes = dict(ragged.ragged_paged_attention.route_launches)
        launches[layout] = {"k1": k1, "k4": k4, "k1_routes": dict(flash.flash_attention.route_launches),
                            "k1_kernels": flash.flash_attention.kernel_launches, "k4_routes": k4_routes,
                            "k4_kernels": ragged.ragged_paged_attention.kernel_launches}
        stats = engine.stats()
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
            k4_steps=pool.get("ragged_kernel_steps"),
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
        if k1_routes["tf32x3"] == 0 or k1_routes["simt"] != 0:
            failures.append(f"K1 routes {k1_routes}: fp32 tiles should take tf32x3, never simt")
        if layout != "dense" and (pool["in_use"] != 0 or pool["leaked"] != 0):
            failures.append(f"pool in_use {pool['in_use']}, leaked {pool['leaked']}")
        if layout != "dense" and pool["ragged_kernel_steps"] != stats["decode_steps"]:
            failures.append(f"{pool['ragged_kernel_steps']} K4 steps of {stats['decode_steps']}")
        if layout == "paged_int8":
            same = sum(int((a == b).sum()) for a, b in zip(rows, served["paged"]))
            line["token_agreement_with_paged"] = same / tokens
        else:
            divergences = []
            for i, (row, ref) in enumerate(zip(rows, refs)):
                diff = [t for t in range(len(ref)) if row[t] != ref[t]]
                if diff:
                    t = diff[0]
                    gap = _top2_gap(torch, gen_mod, model, configs[i], prompts[i], ref, t)
                    divergences.append({"request": i, "token": t, "top2_gap": gap})
                    if gap >= NEAR_TIE:
                        failures.append(f"request {i} diverges at token {t}, top-2 gap {gap}")
            line["divergences_vs_generate"] = divergences
        emit("slot_serve", **line)
        if failures:
            raise AssertionError(f"slot serve {layout}: " + "; ".join(failures))
        del engine
        torch.cuda.empty_cache()
    return launches


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


def train_fit(torch, clm, flash, training, parallel, dtype, root: Path):
    """(b)/(c) ``Trainer.fit`` at full width: 8 optimizer steps of 8 rows with
    2 microbatches, AdamW, cosine warmup, clipping, prefix dropout 0.5, two
    batches cycled, one validation pass at the end."""
    import numpy as np

    cfg = clm_base_config(clm.CausalLanguageModelConfig)
    tname = str(dtype).split(".")[-1]
    model = clm.CausalLanguageModel(cfg, dtype=dtype, seed=0)
    schedule = training.cosine_with_warmup(1e-4, warmup_steps=2, training_steps=TRAIN_STEPS)
    tcfg = training.TrainerConfig(
        max_steps=TRAIN_STEPS, val_check_interval=TRAIN_STEPS, log_every_n_steps=1,
        grad_clip_norm=1.0, grad_accum_steps=2, limit_val_batches=1, enable_tensorboard=False,
        default_root_dir=str(root),
    )
    trainer = training.Trainer(tcfg, training.clm_loss_fn(model, cfg.max_latents),
                               training.make_optimizer(schedule, optimizer="adamw"),
                               model_config=cfg, lr_schedule=schedule)
    *train, held_out = token_batches(cfg.vocab_size, cfg.max_seq_len, 8, 3, seed=31)
    val = [{k: v[:4] for k, v in held_out.items()}]
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
    state = trainer.fit(model, train, val_data=lambda: iter(val))
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
        again = clm.CausalLanguageModel(cfg, seed=1)
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
        state, metrics = step(state, train[i % 2], gen)
        metrics["loss"].item()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
    p50 = float(np.median(step_ms))
    tokens = 8 * cfg.max_latents  # loss tokens per optimizer step
    per_step = {k: v / TRAIN_STEPS for k, v in train_counts.items()}
    line = dict(compute_dtype=tname, steps=TRAIN_STEPS, rows=8, grad_accum_steps=2, losses=losses,
                val_loss=val_loss, launches=train_counts, launches_per_step=per_step,
                validation_launches=val_counts, k1_route_launches=routes, bwd_route_launches=bwd_routes,
                k1_kernel_launches=k1_kernels, fit_s=fit_s,
                step_ms=step_ms, step_ms_p50=p50,
                loss_tokens_per_s=tokens / (p50 / 1e3), max_memory_allocated=peak_bytes,
                checkpoint_reloads_equal=ckpt_equal)
    emit("train_fit", **line)
    failures = []
    if not (len(losses) == TRAIN_STEPS and all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]):
        failures.append(f"losses {losses}")
    if per_step != {"k1": 34, "k2": 34, "k3": 34} or val_counts["k2"] or val_counts["k3"]:
        failures.append(f"launches per step {per_step}, validation {val_counts}")
    expected_route = "wgmma" if dtype == torch.bfloat16 else "tf32x3"  # i = 512 latents
    if routes[expected_route] != counts["k1"]:
        failures.append(f"K1 routes {routes}: every launch should take {expected_route}")
    expected_bwd = K23_ROUTE[tname]
    for key, by_route in bwd_routes.items():
        if by_route[expected_bwd] != counts[key] or sum(by_route.values()) != counts[key]:
            failures.append(f"{key.upper()} routes {by_route}: every launch should take {expected_bwd}")
    if dtype == torch.float32 and not ckpt_equal:
        failures.append("the best checkpoint does not reload into an equal model")
    if failures:
        raise AssertionError(f"train fit {tname}: " + "; ".join(failures))
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
    fits = {}
    for dtype in (torch.float32, torch.bfloat16):
        fits[str(dtype).split(".")[-1]] = train_fit(
            torch, clm, flash, training, parallel, dtype, root / str(dtype).split(".")[-1])
    train_small_vs_cpu(torch, clm, flash, training, parallel)
    k4_refuses_grad(torch, ragged)
    return fits


K1_SOURCES = {
    "split": "perceiver_io_tpu_torch/csrc/flash_attention_fwd_split.cu",
    "wgmma": "perceiver_io_tpu_torch/csrc/flash_attention_fwd_wgmma.cu",
    "tf32x3": "perceiver_io_tpu_torch/csrc/flash_attention_fwd_tf32.cu",
}
K1_LAUNCHES_FROM = {"split": "the bucket serve run (fp32 decode attends)",
                    "tf32x3": "the bucket serve run (fp32 prefill)",
                    "wgmma": "the bf16 Trainer.fit run (8 steps and its validation pass)"}


def k1_route_entry(flash, design: str, main: tuple, cases: list, launches: int) -> dict:
    """The summary line's entry for one of K1's routes: its main case's
    numbers and every case that took it. ``launches`` counts the route's
    calls; ``kernel_launches`` the device kernels they launched."""
    mine = [c for c in cases if c["route"] == design]
    head = next(c for c in mine if (c["case"], c["dtype"], c["d"]) == (*main, K1_HEAD_DIM))
    keys = ("ms", "prev_ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "library_backend")
    if design == "tf32x3":
        keys += ("bound_simt_ms", "bound_simt_by")
    return {
        "name": f"flash_attention_fwd[{design}]", "route": "cuda", "design": design,
        "source": K1_SOURCES[design], "replaces": "perceiver_io_tpu/ops/flash_attention.py:198",
        "launches": launches, "kernel_launches": launches * flash.ROUTE_KERNELS[design],
        "launches_from": K1_LAUNCHES_FROM[design],
        "max_abs_err": max(c["max_abs_err"] for c in mine), "case": f"{main[0]} {main[1]} d={K1_HEAD_DIM}",
        **{k: head[k] for k in keys}, "prev_route": "simt",
        "cases": [{"case": c["case"], "dtype": c["dtype"], "d": c["d"],
                   **{k: c[k] for k in keys if not k.endswith("_by")}} for c in mine],
    }


K4_SOURCES = {"split": "perceiver_io_tpu_torch/csrc/ragged_paged_attention_split.cu",
              "tc": "perceiver_io_tpu_torch/csrc/ragged_paged_attention_tc.cu"}
K4_REPLACES = "perceiver_io_tpu/ops/ragged_attention.py:156"


def k4_route_entry(ragged, design: str, main: tuple, cases: list, launches: int) -> dict:
    """The summary line's entry for one of K4's routes: its main case's
    numbers (fp32, d = 112) and every case that took it. ``launches``
    counts the route's calls in the paged slot-serve run;
    ``kernel_launches`` the device kernels they launched."""
    mine = [c for c in cases if c["route"] == design]
    head = next(c for c in mine if (c["case"], c["layout"], c["d"]) == (*main, K1_HEAD_DIM))
    keys = ("ms", "prev_ms", "plain_ms", "bound_ms", "bound_by", "gather_sdpa_ms")
    if design == "tc":
        keys += ("bound_simt_ms", "bound_simt_by")
    return {
        "name": f"ragged_paged_attention[{design}]", "route": "cuda", "design": design,
        "source": K4_SOURCES[design], "replaces": K4_REPLACES, "launches": launches,
        "kernel_launches": launches * ragged.ROUTE_KERNELS[design],
        "launches_from": "the paged slot-serve run (fp32)",
        "max_abs_err": max(c["max_abs_err"] for c in mine if c["layout"] != "bfloat16"),
        "max_abs_err_bf16": max(c["max_abs_err"] for c in mine if c["layout"] == "bfloat16"),
        "case": f"{main[0]} {main[1]} d={K1_HEAD_DIM}", **{k: head[k] for k in keys},
        "library_ms": None, "prev_route": "simt",
        "cases": [{"case": c["case"], "layout": c["layout"], "d": c["d"],
                   **{k: c[k] for k in keys if not k.endswith("_by")}, "max_abs_err": c["max_abs_err"]}
                  for c in mine],
    }


K23_SOURCES = {"wgmma": "perceiver_io_tpu_torch/csrc/flash_attention_bwd_wgmma.cu",
               "tf32x3": "perceiver_io_tpu_torch/csrc/flash_attention_bwd_tf32.cu"}
#: per K23 kernel: (wrapper name, TPU function, counter key, gradients)
K23_KERNELS = {
    "dq": ("flash_attention_bwd_dq", "perceiver_io_tpu/ops/flash_attention.py:290", "k2", ("dq",)),
    "dkv": ("flash_attention_bwd_dkv", "perceiver_io_tpu/ops/flash_attention.py:367", "k3", ("dk", "dv")),
}


def k23_entries(kname: str, fits: dict, cases: list) -> list:
    """The summary line's entries for K2 (``dq``) or K3 (``dkv``), one per
    route the main path runs (``wgmma`` in bf16, ``tf32x3`` in fp32): the
    cross case (i = 512, j = 768, d = 112) of its type at the top, launches
    from the Trainer.fit run of its type, and every case that took it."""
    name, replaces, count, grads = K23_KERNELS[kname]
    entries = []
    for tname, design in (("bfloat16", K23_ROUTE["bfloat16"]), ("float32", K23_ROUTE["float32"])):
        keys = ("ms", "prev_ms", "plain_ms", "bound_ms", "bound_by")
        if design == "tf32x3":
            keys += ("bound_simt_ms", "bound_simt_by")
        mine = [c for c in cases if c["dtype"] == tname]
        head = next(c for c in mine if c["case"] == "cross" and c["j"] == 768)
        entries.append({
            "name": f"{name}[{design}]", "route": "cuda", "design": design, "source": K23_SOURCES[design],
            "replaces": replaces, "launches": fits[tname]["bwd_route_launches"][count][design],
            "launches_from": f"the {tname} Trainer.fit run (8 steps)",
            "max_abs_err": max(c["max_abs_err"][g] for c in mine for g in grads),
            **{k: head["kernels"][kname][k] for k in keys},
            "library_ms": head["library_ms"], "library_backend": head["library_backend"],
            "library_note": "backward of scaled_dot_product_attention (memory-efficient backend), "
                            "dq, dk and dv together",
            "shape": f"cross-attention b=4 h=8 i=512 j=768 d=112 {tname}, causal, left pads",
            "prev_route": "simt",
            "cases": [{"case": c["case"], "i": c["i"], "j": c["j"], "d": c["d"],
                       **{k: c["kernels"][kname][k] for k in keys if not k.endswith("_by")},
                       "library_ms": c["library_ms"], "rel_err": {g: c["rel_err"][g] for g in grads},
                       "prev_rel_err": {g: c["prev_rel_err"][g] for g in grads}}
                      for c in mine],
        })
    return entries


def ptxas_by_kernel(log: str) -> dict:
    """``nvcc -Xptxas -v`` output as {kernel: {instances, registers [min,
    max], max spill store bytes}}, kernels named by their function name."""
    out = {}
    name = None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '.*?\d+((?:flash|ragged)_\w*?kernel)", line)
        if entry:
            name = entry.group(1)
            out.setdefault(name, {"instances": 0, "registers": [], "max_spill_store_bytes": 0})
            out[name]["instances"] += 1
        elif name and "Used" in line and "registers" in line:
            out[name]["registers"].append(int(re.search(r"Used (\d+) registers", line).group(1)))
        elif name and "spill stores" in line:
            spill = int(re.search(r"(\d+) bytes spill stores", line).group(1))
            out[name]["max_spill_store_bytes"] = max(out[name]["max_spill_store_bytes"], spill)
    for rec in out.values():
        rec["registers"] = [min(rec["registers"], default=0), max(rec["registers"], default=0)]
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from perceiver_io_tpu_torch import _build
    from perceiver_io_tpu_torch.inference import generate as gen_mod
    from perceiver_io_tpu_torch.models.text import clm
    from perceiver_io_tpu_torch.ops import flash_attention as flash
    from perceiver_io_tpu_torch.ops import paged_attention as paged
    from perceiver_io_tpu_torch.ops import ragged_attention as ragged
    from perceiver_io_tpu_torch.serving import buckets
    from perceiver_io_tpu_torch.serving import engine as engine_mod
    from perceiver_io_tpu_torch.serving import slots as slots_mod
    from perceiver_io_tpu_torch import parallel, training

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    emit("device", nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
         kind=torch.cuda.get_device_name(0), count=torch.cuda.device_count())

    t0 = time.perf_counter()
    _build.build_all()
    emit("build", seconds=time.perf_counter() - t0, sources=_build.sources(),
         ptxas={name: ptxas_by_kernel(log) for name, log in _build.BUILD_LOG.items()})
    cases = kernel_cases(torch, flash)
    k1_refusals(torch, flash)
    model_phase(torch, clm, flash, gen_mod)
    launches, serve_routes, serve_kernels = serve_phase(torch, clm, flash, gen_mod, engine_mod, buckets)
    k4 = k4_cases(torch, ragged, paged)
    k4_refusals(torch, ragged)
    slot_launches = slot_serve_phase(torch, clm, flash, ragged, gen_mod, slots_mod, buckets)
    k23 = k23_cases(torch, flash)
    train_root = ROOT / "build" / "chip_smoke_train"
    shutil.rmtree(train_root, ignore_errors=True)
    fits = train_phase(torch, clm, flash, ragged, training, parallel, train_root)

    main_case = next(c for c in cases
                     if (c["case"], c["dtype"], c["d"]) == ("cross", "float32", K1_HEAD_DIM))
    route_launches = {"split": serve_routes["split"], "tf32x3": serve_routes["tf32x3"],
                      "wgmma": fits["bfloat16"]["k1_route_launches"]["wgmma"]}
    k4_case = next(c for c in k4 if (c["case"], c["layout"], c["d"]) == ("decode", "float32", K1_HEAD_DIM))
    k4_paged = slot_launches["paged"]
    print(json.dumps({"kernels": [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": K1_SOURCES["tf32x3"],
        "replaces": "perceiver_io_tpu/ops/flash_attention.py:198",
        "launches": launches,
        "kernel_launches": serve_kernels,
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
        "routes": [k1_route_entry(flash, design, main, cases, route_launches[design])
                   for design, main in (("split", ("decode", "float32")), ("wgmma", ("cross", "bfloat16")),
                                        ("tf32x3", ("cross", "float32")))],
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
        "routes": [k4_route_entry(ragged, design, main, k4, k4_paged["k4_routes"][design])
                   for design, main in (("split", ("decode", "float32")), ("tc", ("window", "float32")))],
    }] + [e for kname in ("dq", "dkv") for e in k23_entries(kname, fits, k23)]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
