"""Shared pieces of the port's outer-serving tests (fleet, elasticity,
gateway): both packages behind one namespace a script is written against
once, a tiny CLM converted once from JAX per config, and the views of a
run that are compared (tokens, statuses, counters, histogram counts,
spans and events with their attributes; no millisecond value)."""
import functools
import importlib
import types

import jax
import jax.numpy as jnp
import numpy as np

#: span and event attributes that are wall-clock readings (the engines'
#: device ms): compared for presence only
CLOCK_ATTRS = ("prefill_ms", "ms", "execute_ms", "assemble_ms", "decode_step_ms", "ttft_ms",
               "inter_token_ms", "itl_ms", "recompute_est_ms", "swap_est_ms", "swap_measured_ms",
               "swap_advantage_ms")
#: counters only the port keeps
PORT_ONLY = {"serving_decode_boundary_steps_total"}


@functools.lru_cache(maxsize=None)
def tiny_pair(**cfg):
    """``(jax_model, params, port_model)``: one JAX init at ``cfg``, carried to
    the port by ``convert/from_jax.py``."""
    from perceiver_io_tpu.models.text.clm import CausalLanguageModel as JaxCLM
    from perceiver_io_tpu.models.text.clm import CausalLanguageModelConfig as JaxConfig
    from perceiver_io_tpu_torch.convert.from_jax import load_jax_params
    from perceiver_io_tpu_torch.models.text.clm import CausalLanguageModel, CausalLanguageModelConfig

    j_model = JaxCLM(JaxConfig(**cfg))
    n = cfg["max_seq_len"]
    init = jax.jit(j_model.init, static_argnums=2)
    params = init(jax.random.PRNGKey(0), jnp.zeros((1, n), jnp.int32), cfg["max_latents"])["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    t_model = CausalLanguageModel(CausalLanguageModelConfig(**cfg), device="cpu")
    return j_model, params, load_jax_params(t_model, params).eval()


def side(name: str, pair) -> types.SimpleNamespace:
    """One package's serving surface: its modules, and engine factories over
    the shared tiny model (the port's on the CPU by name)."""
    root = "perceiver_io_tpu" if name == "jax" else "perceiver_io_tpu_torch"
    mod = lambda sub: importlib.import_module(f"{root}.{sub}")  # noqa: E731
    serving, obs, rel = mod("serving"), mod("observability"), mod("reliability")
    gen_mod = mod("inference.generate")
    j_model, params, t_model = pair

    def gen(**kw):
        if name == "jax":
            from perceiver_io_tpu.inference.samplers import SamplingConfig

            kw.setdefault("sampling", SamplingConfig(temperature=0.0))
        return gen_mod.GenerationConfig(**kw)

    def table(prompt_lens, batch_sizes=(1,)):
        return serving.BucketTable(prompt_lens=tuple(prompt_lens), batch_sizes=tuple(batch_sizes))

    def slot(cfg, tab, **kw):
        if name == "jax":
            return serving.SlotServingEngine(j_model, params, cfg, tab, rng=jax.random.PRNGKey(1), **kw)
        return serving.SlotServingEngine(t_model, cfg, tab, device="cpu", **kw)

    def bucket(cfg, tab, **kw):
        if name == "jax":
            return serving.ServingEngine(j_model, params, cfg, tab, rng=jax.random.PRNGKey(1), **kw)
        return serving.ServingEngine(t_model, cfg, tab, device="cpu", **kw)

    def ref(prompt, cfg):
        """Per-request ``generate()``: the oracle."""
        p = np.asarray(prompt, np.int32)[None]
        if name == "jax":
            return np.asarray(gen_mod.generate(j_model, params, jnp.asarray(p), cfg))[0]
        return gen_mod.generate(t_model, p, cfg, device="cpu")[0].cpu().numpy()

    return types.SimpleNamespace(
        name=name, serving=serving, obs=obs, rel=rel, report=mod("observability.report"),
        exporters=mod("observability.exporters"), fleet_mod=mod("serving.fleet"),
        gateway_mod=mod("serving.gateway"), slo=mod("observability.slo"), gen=gen, table=table, slot=slot, bucket=bucket, ref=ref)


def sides(pair) -> dict:
    return {"jax": side("jax", pair), "port": side("port", pair)}


def tokens(reqs) -> list:
    return [None if r.result is None else np.asarray(r.result).tolist() for r in reqs]


def _mask(attrs: dict) -> dict:
    return {k: ("<clock>" if k in CLOCK_ATTRS else v) for k, v in attrs.items()}


def span_view(tracer, name=None) -> list:
    """Spans and events in emission order: name, trace id, status and
    attributes (wall-clock ones masked)."""
    return [(sp.name, sp.trace_id, sp.status, _mask(sp.attrs)) for sp in tracer.spans(name)]


def registry_view(registry) -> dict:
    """Counters (the port-only one left out), gauges and histogram counts."""
    snap = registry.snapshot()
    return {
        "counters": {k: v for k, v in snap["counters"].items() if k not in PORT_ONLY},
        "gauges": {k: v for k, v in snap["gauges"].items()},
        "histogram_counts": {k: h["count"] for k, h in snap["histograms"].items()},
    }


def fleet_view(fleet, reqs=()) -> dict:
    """Everything a fleet run is held to: tokens, statuses, dispatch counts,
    the fleet registry, each live replica's engine counters and pool frees,
    and the fleet's spans."""
    reps = []
    for r in fleet.replicas:
        eng = r.engine
        pool = getattr(eng, "_pool", None)
        reps.append({
            "replica_id": r.replica_id, "breaker": r.breaker.state, "restarts": r.restarts,
            "in_flight": len(r.handles),
            "counters": {k: v for k, v in eng.registry.counters().items() if k not in PORT_ONLY},
            "frees_by_cause": None if pool is None else dict(pool.frees_by_cause),
        })
    stats = fleet.stats()
    for key in ("request_latency_ms", "ttft_ms", "inter_token_ms", "per_replica"):
        stats.pop(key)
    return {
        "tokens": tokens(reqs), "status": [r.status for r in reqs],
        "dispatches": [r.dispatches for r in reqs], "replica": [r.replica_id for r in reqs],
        "errors": [r.error for r in reqs], "registry": registry_view(fleet.registry),
        "replicas": reps, "stats": stats,
        "spans": [] if fleet.tracer is None else span_view(fleet.tracer),
    }
