#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA H100 and check it.

    python3 chip_smoke.py

Phases, each printing JSON lines (any failure raises, so the script exits
non-zero and never prints the final line):

1. device: the card's name and power limit (``nvidia-smi``);
2. build: ``nvcc`` builds every kernel under ``perceiver_io_tpu_torch/csrc``;
3. kernel: the flash attention kernel (K1) against its plain PyTorch
   version at the serving path's shapes (i = 512 latents, 8 heads, head dim
   112: cross-attention over j = 1024 with left-pad dead rows, the latent
   stack at j = 512, the q_len = 1 decode attend), fp32 and bf16, with its
   time, the plain version's, ``scaled_dot_product_attention``'s (a
   yardstick the port never calls) and the card's bound;
4. model: the full-width C4 CLM ("clm-base": vocab 32000, 1024 context, 512
   latents, 896 channels, 8 heads, 16 layers; random weights from a seed),
   one forward with the kernel against ``attention_impl="xla"``, fp32 and
   bf16 compute; and a small model's greedy tokens on the card against the
   same model on the CPU;
5. serve: ``ServingEngine.serve()`` over the full-width model (fp32): 8
   ragged requests in two configs that together run prefill, latent growth,
   prefix growth and the sliding window; served tokens must equal
   per-request ``generate()``;
6. the ``{"kernels": [...]}`` summary line, the card's ``nvidia-smi`` line,
   and the final ``{"ok": true, ...}`` line.

fp32 comparisons run with TF32 off (``torch.backends.cuda.matmul.allow_tf32``
and ``torch.backends.cudnn.allow_tf32`` set False).
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # tensor bf16; fp32 outside the tensor cores
KERNEL_TOL = {"float32": 1e-4, "bfloat16": 2e-2}


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


def kernel_cases(torch, flash):
    """K1 against its plain version at the serving path's shapes."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(0)
    b, h, d = 4, 8, 112
    cases = []
    for name, i, j, pads, lengths in (
        ("cross", 512, 1024, [0, 100, 600, 900], None),   # left pads; rows 0..387 of row 3 dead
        ("stack", 512, 512, [0, 10, 200, 400], None),     # not-yet-latent slots masked
        ("decode", 1, 1024, None, [1023, 700, 300, 40]),  # keys past the cache length masked
    ):
        cols = torch.arange(j, device="cuda")[None, :]
        if pads is not None:
            pad = cols < torch.tensor(pads, device="cuda")[:, None]
        else:
            pad = cols > torch.tensor(lengths, device="cuda")[:, None]
        causal_ok = cols <= torch.arange(i, device="cuda")[:, None] + (j - i)
        allowed = causal_ok[None] & ~pad[:, None, :]  # (b, i, j)
        live = allowed.any(-1)  # (b, i)
        pairs = int(allowed.sum().item()) * h
        for dtype in (torch.float32, torch.bfloat16):
            q = (torch.randn(b, h, i, d, generator=gen, device="cuda") * d**-0.5).to(dtype)
            k = torch.randn(b, h, j, d, generator=gen, device="cuda").to(dtype)
            v = torch.randn(b, h, j, d, generator=gen, device="cuda").to(dtype)
            o, lse = flash.flash_attention_fwd(q, k, v, pad_mask=pad, causal=True)
            o_ref, lse_ref = flash.flash_attention_reference(q, k, v, pad_mask=pad, causal=True)
            torch.cuda.synchronize()
            live4 = live[:, None, :, None].expand_as(o)
            err = (o.float() - o_ref.float()).abs()[live4].max().item()
            lse_err = (lse - lse_ref).abs()[live[:, None, :].expand_as(lse)].max().item()
            dead_zero = bool((o[~live4] == 0).all().item())
            tname = str(dtype).split(".")[-1]
            tol = KERNEL_TOL[tname]
            if not (err <= tol and lse_err <= 1e-3 and dead_zero):
                raise AssertionError(
                    f"K1 {name} {tname}: max|d| {err} (tol {tol}), lse {lse_err}, dead rows zero {dead_zero}"
                )
            iters = 50 if i > 1 else 200
            ms = cuda_ms(lambda: flash.flash_attention_fwd(q, k, v, pad_mask=pad, causal=True), iters)
            plain_ms = cuda_ms(
                lambda: flash.flash_attention_reference(q, k, v, pad_mask=pad, causal=True), 10
            )
            attn_mask = allowed[:, None]
            library_ms = cuda_ms(
                lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=attn_mask, scale=1.0), iters
            )
            esize = q.element_size()
            nbytes = (q.numel() + k.numel() + v.numel() + o.numel()) * esize + lse.numel() * 4 + pad.numel()
            flops = 4 * d * pairs  # q.k and p.v over the keys this data lets each row see
            bound_s = max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[tname])
            case = dict(
                case=name, dtype=tname, b=b, h=h, i=i, j=j, d=d, max_abs_err=err,
                tol=tol, lse_max_abs_err=lse_err, dead_rows=int((~live).sum().item()),
                dead_rows_zero=dead_zero, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_s * 1e3,
                bound_by="bytes" if nbytes / HBM_BYTES_PER_S >= flops / PEAK_FLOPS[tname] else "operations",
                bytes=nbytes, flops=flops,
            )
            emit("kernel", **case)
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

    flash.flash_attention.launches = 0  # count the main path's launches only
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    served = [engine.serve(prompts, c) for c, prompts in work]
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = flash.flash_attention.launches

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
         k1_launches=launches, k1_launches_per_token=launches / tokens,
         per_request_generate_mismatches=mismatches, compute_dtype="float32")
    if stats["completed"] != 8 or launches <= 0 or mismatches:
        raise AssertionError(f"serve: completed {stats['completed']}, launches {launches}, "
                             f"mismatching requests {mismatches}")
    return launches


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
    from perceiver_io_tpu_torch.serving import buckets
    from perceiver_io_tpu_torch.serving import engine as engine_mod

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
    ptxas = [line.strip() for log in _build.BUILD_LOG.values() for line in log.splitlines()
             if "registers" in line or "spill" in line]
    emit("build", seconds=time.perf_counter() - t0, sources=_build.sources(), ptxas=ptxas[:24])
    cases = kernel_cases(torch, flash)
    model_phase(torch, clm, flash, gen_mod)
    launches = serve_phase(torch, clm, flash, gen_mod, engine_mod, buckets)

    main_case = next(c for c in cases if c["case"] == "cross" and c["dtype"] == "float32")
    print(json.dumps({"kernels": [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "perceiver_io_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": "perceiver_io_tpu/ops/flash_attention.py:198",
        "launches": launches,
        "max_abs_err": max(c["max_abs_err"] for c in cases if c["dtype"] == "float32"),
        "ms": main_case["ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"],
        "shape": "cross-attention b=4 h=8 i=512 j=1024 d=112 fp32, causal, left pads",
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
