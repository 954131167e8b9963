"""Shared pieces of the port's observability tests: one tiny CLM config (2
layers, 16 channels, vocab 64) converted once from JAX, the telemetry kit
both packages' engines get, and the masks that drop wall-clock readings."""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np

TINY = dict(vocab_size=64, max_seq_len=32, max_latents=8, num_channels=16, num_heads=2,
            num_self_attention_layers=2)
N = 32

#: span and event attributes that are wall-clock readings: compared for
#: presence only (the engines read their clocks at different points)
CLOCK_ATTRS = ("ttft_ms", "inter_token_ms", "itl_ms", "prefill_ms", "ms", "execute_ms",
               "assemble_ms", "decode_step_ms", "recompute_est_ms", "swap_est_ms",
               "swap_advantage_ms", "swap_measured_ms")
#: span row fields that are wall-clock readings
CLOCK_ROW = ("start_s", "end_s", "duration_ms")


@functools.lru_cache(maxsize=None)
def tiny_pair():
    """``(jax_model, params, port_model)``: one JAX init, converted to the port."""
    from perceiver_io_tpu.models.text.clm import CausalLanguageModel as JaxCLM
    from perceiver_io_tpu.models.text.clm import CausalLanguageModelConfig as JaxConfig
    from perceiver_io_tpu_torch.convert.from_jax import load_jax_params
    from perceiver_io_tpu_torch.models.text.clm import CausalLanguageModel, CausalLanguageModelConfig

    j_model = JaxCLM(JaxConfig(**TINY))
    init = jax.jit(j_model.init, static_argnums=2)
    params = init(jax.random.PRNGKey(0), jnp.zeros((1, N), jnp.int32), 8)["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    t_model = CausalLanguageModel(CausalLanguageModelConfig(**TINY), device="cpu")
    return j_model, params, load_jax_params(t_model, params).eval()


def obs_modules(side: str):
    import importlib

    root = "perceiver_io_tpu" if side == "jax" else "perceiver_io_tpu_torch"
    return importlib.import_module(f"{root}.observability")


def kit(side: str, clock, root: str, *, slo=None, incident: bool = True):
    """Every attachment the engines take: registry, tracer (to
    ``<root>/events.jsonl``), timeline, flight recorder, SLO monitor."""
    obs = obs_modules(side)
    os.makedirs(root, exist_ok=True)
    reg = obs.MetricsRegistry(clock=clock)
    sink = obs.JsonlSpanSink(os.path.join(root, "events.jsonl"))
    tracer = obs.Tracer(clock=clock, sink=sink)
    timeline = obs.StepTimeline(cap=1024, registry=reg)
    rec = obs.FlightRecorder(os.path.join(root, "incidents"), tracer=tracer, registry=reg,
                             clock=clock, cooldown_s=3600.0) if incident else None
    mon = obs.SLOMonitor(obs.SLOPolicy(**(slo or {"ttft_p95_ms": 1e6})), clock=clock, registry=reg,
                         tracer=tracer, flight_recorder=rec, fast_window_s=5.0, slow_window_s=20.0,
                         min_samples=2)
    return dict(registry=reg, tracer=tracer, sink=sink, timeline=timeline, recorder=rec, slo=mon)


def attach(engine, k) -> None:
    """Attach a kit's timeline, recorder and SLO feeds to an engine."""
    engine.timeline = k["timeline"]
    engine.flight_recorder = k["recorder"]
    engine.latency_sink = k["slo"].sink
    k["slo"].watch_counters(k["registry"].counters, prefix="serving")
    if k["recorder"] is not None:
        k["recorder"].add_source("health", engine.health)
        if getattr(engine, "_pool", None) is not None:
            k["recorder"].add_source("kv_pool", engine._pool.stats)


def _mask_attrs(attrs: dict) -> dict:
    return {k: ("<clock>" if k in CLOCK_ATTRS else v) for k, v in attrs.items()}


def span_rows(tracer) -> list:
    """The tracer's finished spans, wall-clock fields masked."""
    out = []
    for span in tracer.spans():
        row = span.to_row()
        for key in CLOCK_ROW:
            if key in row:
                row[key] = "<clock>"
        row["attrs"] = _mask_attrs(row.get("attrs", {}))
        out.append(row)
    return out


def mask_timeline(records: list) -> list:
    out = []
    for rec in records:
        rec = dict(rec)
        for key in ("t_start_s", "t_end_s"):
            rec[key] = "<clock>"
        rec["phases_ms"] = sorted(rec["phases_ms"])
        for kind, events in list(rec.items()):
            if isinstance(events, list) and events and isinstance(events[0], dict):
                rec[kind] = [_mask_attrs(e) for e in events]
        out.append(rec)
    return out


def bundle_view(path: str) -> dict:
    """An incident bundle's manifest and span slice, wall-clock fields masked."""
    import json

    with open(os.path.join(path, "manifest.json")) as fh:
        manifest = json.load(fh)
    with open(os.path.join(path, "spans.jsonl")) as fh:
        spans = [json.loads(line) for line in fh if line.strip()]
    for row in spans:
        for key in CLOCK_ROW:
            row.pop(key, None)
        row["attrs"] = _mask_attrs(row.get("attrs", {}))
    trigger = dict(manifest["trigger"], at_s="<clock>")
    return {"name": os.path.basename(path), "trigger": trigger, "spans": spans,
            "n_spans": manifest["spans"], "sources": sorted(manifest["sources"])}
