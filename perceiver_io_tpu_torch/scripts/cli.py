"""Config-driven training and serving CLI of the port. Counterpart of
``perceiver_io_tpu/scripts/cli.py`` (the reference's LightningCLI surface,
``perceiver/scripts/cli.py:13-48``, without Lightning/jsonargparse):

    python -m perceiver_io_tpu_torch.scripts.text.clm fit \\
        --data=synthetic --data.max_seq_len=1024 \\
        --model.num_channels=512 --optimizer.lr=2e-4 \\
        --trainer.max_steps=10000 --trainer.default_root_dir=logs
    python -m perceiver_io_tpu_torch.scripts.text.clm serve \\
        --ckpt=logs/checkpoints --serve.prompts=prompts.txt

Flags are generated from dataclass fields (``--model.*`` from the family's
model config, ``--data.*`` from the datamodule constructor, ``--trainer.*``
from :class:`~perceiver_io_tpu_torch.training.trainer.TrainerConfig`, plus
``--optimizer.*`` / ``--lr_scheduler.*`` / ``--serve.*``). ``--config
file.yaml`` loads defaults (CLI flags win); ``link`` functions propagate
data-derived values into the model config (e.g. vocab_size). Subcommands:
``fit``, ``validate``, ``test``, ``preproc``, ``serve`` and ``obs``; ``validate`` and
``test`` take ``--ckpt <dir>`` to evaluate a saved model; ``serve`` takes
``--ckpt <dir>`` plus ``--serve.*`` flags and runs text generation through
the bucket or the slot engine, prompts from a file or stdin, one JSON line
per completion and the engine's stats at the end; ``obs report|incident|
timeline`` render what a run's ``--obs.*`` telemetry wrote. The flags, their
parsing, the subcommands and every ``SystemExit`` message are the JAX
package's.

The port's own flag is ``--device`` (default ``cuda``): it places the model,
the trainer and the engine; the CPU runs only on ``--device=cpu``.

``--obs.*`` (``fit`` and ``serve``) builds the run's telemetry as JAX's CLI
does: the metrics registry, the span tracer and its ``events.jsonl`` sink
(with sampling and rotation), the snapshot writer, the profiler trigger
(``torch.profiler`` Chrome traces under ``<root>/profile_regress``) and,
for ``serve``, the SLO monitor, the incident flight recorder and the step
timeline. Serve lines carry the request's ``trace_id``; ``serve_stats``
carries the registry (``metrics``), the build ledger (``compile_ledger``)
and the process-wide registry (``process_metrics``).

``serve`` also runs a supervised fleet (``--serve.replicas`` above 1,
``--serve.failover``, ``--serve.step_timeout_s``), its autoscaler
(``--serve.autoscale.*``, which builds the fleet even at one replica) and
the HTTP/SSE streaming gateway (``--serve.http.*``: prompts arrive over
``POST /v1/generate`` instead of a file), with JAX's checks.

``fit``, ``validate`` and ``test`` take ``--mesh.*`` (JAX's training mesh):
under ``torchrun`` each process is one rank, ``--device=cuda`` puts it on
``cuda:LOCAL_RANK`` (NCCL) and ``--device=cpu`` on the CPU (gloo); a lone
process without ``--mesh.*`` trains as before, and with it resolves the
mesh over a world of one. Rank 0 alone writes the run directory.

``serve`` takes ``--serve.mesh.{data,model,device_offset}`` (the sharded
slot engine, :mod:`perceiver_io_tpu_torch.serving.sharding`): under
``torchrun`` every rank loads the checkpoint and builds one
``MeshGroupAllocator``, which hands each engine spawn (replica, crash
rebuild, scale-up) its disjoint rank group; rank 0 serves and prints, the
other ranks follow their group's plans and print nothing.

Model-family entry points are declarative :class:`ModelFamily` records; see
``perceiver_io_tpu_torch/scripts/text/clm.py`` for the pattern.
"""
from __future__ import annotations

import dataclasses
import enum
import os
import sys
import typing
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np

from perceiver_io_tpu_torch.observability import ObservabilityArgs


# -- dataclass <-> flags ---------------------------------------------------
def _unwrap_optional(tp):
    origin = typing.get_origin(tp)
    if origin is typing.Union:
        args = [a for a in typing.get_args(tp) if a is not type(None)]
        if len(args) == 1:
            return args[0], True
    return tp, False


def _parse_value(text: str, tp) -> Any:
    tp, optional = _unwrap_optional(tp)
    if optional and text.lower() in ("none", "null"):
        return None
    origin = typing.get_origin(tp)
    if tp is bool:
        if text.lower() in ("true", "1", "yes"):
            return True
        if text.lower() in ("false", "0", "no"):
            return False
        raise ValueError(f"invalid bool {text!r}")
    if tp in (int, float, str):
        return tp(text)
    if isinstance(tp, type) and issubclass(tp, enum.Enum):
        return tp[text]
    if origin in (tuple, list):
        elem = (typing.get_args(tp) or (str,))[0]
        if elem is Ellipsis:
            elem = str
        items = [t for t in text.replace("(", "").replace(")", "").split(",") if t != ""]
        seq = [_parse_value(t.strip(), elem) for t in items]
        return tuple(seq) if origin is tuple else seq
    # fall back to python literal-ish string
    return text


def _coerce(value: Any, tp) -> Any:
    """Coerce a YAML-loaded value to the field type."""
    if isinstance(value, str):
        return _parse_value(value, tp)
    tp2, _ = _unwrap_optional(tp)
    if value is not None and typing.get_origin(tp2) is tuple:
        return tuple(value)
    if value is not None and isinstance(tp2, type) and issubclass(tp2, enum.Enum) and not isinstance(value, tp2):
        return tp2[value]
    return value


def flag_specs(cls, prefix: str, nested: Optional[Dict[str, type]] = None) -> Dict[str, Any]:
    """``{dotted_flag: type}`` for a dataclass, recursing into nested
    dataclass fields (``nested`` overrides TypeVar-typed fields with
    concrete classes)."""
    nested = nested or {}
    specs: Dict[str, Any] = {}
    cls = typing.get_origin(cls) or cls
    hints = typing.get_type_hints(cls)
    for field in dataclasses.fields(cls):
        tp = nested.get(field.name, hints.get(field.name, str))
        if dataclasses.is_dataclass(tp):
            specs.update(flag_specs(tp, f"{prefix}.{field.name}"))
        else:
            specs[f"{prefix}.{field.name}"] = tp
    return specs


def build_dataclass(cls, values: Dict[str, Any], prefix: str,
                    nested: Optional[Dict[str, type]] = None):
    """Instantiate ``cls`` from dotted ``values``."""
    nested = nested or {}
    cls = typing.get_origin(cls) or cls
    hints = typing.get_type_hints(cls)
    kwargs = {}
    for field in dataclasses.fields(cls):
        tp = nested.get(field.name, hints.get(field.name, str))
        key = f"{prefix}.{field.name}"
        if dataclasses.is_dataclass(tp):
            sub_keys = [k for k in values if k.startswith(key + ".")]
            if sub_keys or not _has_default(field):
                kwargs[field.name] = build_dataclass(tp, values, key)
        elif key in values:
            kwargs[field.name] = _coerce(values[key], tp)
    return cls(**kwargs)


def _has_default(field) -> bool:
    return (
        field.default is not dataclasses.MISSING
        or field.default_factory is not dataclasses.MISSING
    )


# -- optimizer / scheduler args -------------------------------------------
@dataclasses.dataclass
class OptimizerArgs:
    """``--optimizer.*`` (reference exposes these via Lightning's optimizer
    wiring, ``scripts/cli.py:37-48``)."""

    lr: float = 1e-3
    optimizer: str = "adamw"
    weight_decay: float = 0.0
    b1: float = 0.9
    b2: float = 0.999


@dataclasses.dataclass
class LRSchedulerArgs:
    """``--lr_scheduler.*`` (reference ``perceiver/scripts/lrs.py:7-38``)."""

    name: str = "cosine"  # cosine | constant | none
    warmup_steps: int = 0
    min_fraction: float = 0.1
    training_steps: Optional[int] = None  # linked to trainer.max_steps


# -- the serve subcommand's nested flag groups -----------------------------
@dataclasses.dataclass
class HttpArgs:
    """``--serve.http.*``: the HTTP/SSE streaming gateway; ``port`` set
    (0 picks a free one) serves over sockets instead of the prompts loop."""

    port: Optional[int] = None
    host: str = "127.0.0.1"
    stream: str = "sse"
    max_streams: Optional[int] = None


@dataclasses.dataclass
class MeshServeArgs:
    """``--serve.mesh.*``: the sharded serving runtime (data x model ranks
    a replica, at ``device_offset`` into the world)."""

    data: int = 1
    model: int = 1
    device_offset: int = 0


@dataclasses.dataclass
class AutoscaleArgs:
    """``--serve.autoscale.*``: SLO-driven fleet elasticity, enabled by
    ``max``."""

    max: Optional[int] = None
    min: int = 1
    up_cooldown_s: float = 15.0
    down_cooldown_s: float = 60.0
    up_evidence: int = 2
    down_evidence: int = 5
    queue_high: float = 1.0
    queue_low: float = 0.25
    scale_up_slots: Optional[int] = None


@dataclasses.dataclass
class MeshConfig:
    """``--mesh.*``: the training mesh's parallelism degrees."""

    data: int = -1
    fsdp: int = 1
    model: int = 1
    seq: int = 1


def _serve_mesh(values: Dict[str, Any], args) -> Optional[Any]:
    """The ``--serve.mesh.*`` base spec, or None without the flags (any
    flag opts in, an explicit 1x1 mesh too), with JAX's checks: the slot
    engine only, and the initial fleet must fit the world (the ranks
    ``torchrun`` starts)."""
    if not any(k.startswith("serve.mesh.") for k in values):
        return None
    if args.engine != "slots":
        raise SystemExit(
            "--serve.mesh.* applies to --serve.engine=slots "
            "(the sharded runtime runs the slot engine's device ops "
            "over the mesh; the bucket engine is single-device)"
        )
    import torch.distributed as dist

    from perceiver_io_tpu_torch.serving.sharding import ServingMeshSpec, fleet_mesh_specs

    world = dist.get_world_size() if dist.is_initialized() else int(os.environ.get("WORLD_SIZE", "1"))
    try:
        spec = ServingMeshSpec(data=args.mesh.data, model=args.mesh.model,
                               device_offset=args.mesh.device_offset)
        # the INITIAL fleet must fit the world outright (autoscaler spawns
        # past it wrap around the allocator)
        fleet_mesh_specs(spec, max(1, args.replicas), ranks=list(range(world)))
    except ValueError as e:
        raise SystemExit(f"--serve.mesh.*: {e}")
    return spec


def _training_mesh(values: Dict[str, Any], device):
    """The ``--mesh.*`` mesh of a fit/validate/test, or None: built when a
    ``--mesh.*`` flag is given or the process is one of several
    (``torchrun``), over the process group (brought up here)."""
    from perceiver_io_tpu_torch.parallel import make_mesh, multihost
    from perceiver_io_tpu_torch.parallel.mesh import MeshConfig as ParallelMeshConfig

    if not any(k.startswith("mesh.") for k in values) and int(os.environ.get("WORLD_SIZE", "1")) == 1:
        return None
    cfg = build_dataclass(MeshConfig, values, "mesh")
    multihost.initialize(device=device)
    return make_mesh(ParallelMeshConfig(**dataclasses.asdict(cfg)), device=device)


def _obs_kit(obs, root: str, *, passed: Optional[set] = None) -> Dict[str, Any]:
    """Build the ``--obs.*`` flag group into the run's registry, tracer,
    events sink, snapshot writer, profiler trigger, SLO monitor, flight
    recorder and timeline (JAX's ``_obs_kit`` on one process). Every field
    defaults to off; relative paths land under ``root``. Callers close
    ``kit["sink"]``."""
    import os
    import time

    from perceiver_io_tpu_torch.observability import (
        FlightRecorder,
        JsonlSpanSink,
        MetricsRegistry,
        ProfilerTrigger,
        SamplingSpanSink,
        SLOMonitor,
        SnapshotWriter,
        StepTimeline,
        Tracer,
        default_ledger,
        default_registry,
    )

    def _resolve(path: str) -> str:
        if not os.path.isabs(path):
            path = os.path.join(root, path)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        return path

    # the sampling and rotation knobs shape the events stream: asking for
    # them without a stream must not silently do nothing
    if obs.events_path is None:
        for flag, value in (("--obs.trace_sample", obs.trace_sample),
                            ("--obs.trace_keep_slow_ms", obs.trace_keep_slow_ms),
                            ("--obs.events_max_bytes", obs.events_max_bytes)):
            if value is not None:
                raise SystemExit(f"{flag} shapes the span stream; set --obs.events_path "
                                 "to enable it (docs/observability.md)")
    if obs.trace_sample is not None and not 0.0 < obs.trace_sample <= 1.0:
        raise SystemExit(f"--obs.trace_sample must be in (0, 1], got {obs.trace_sample}")
    if obs.trace_keep_slow_ms is not None and obs.trace_sample is None:
        raise SystemExit("--obs.trace_keep_slow_ms is a trace-sampling tail-keep rule; "
                         "set --obs.trace_sample to enable sampling")
    registry = MetricsRegistry()
    sink = None
    tracer = None
    if obs.events_path is not None:
        sink = JsonlSpanSink(_resolve(obs.events_path), max_bytes=obs.events_max_bytes)
        if obs.trace_sample is not None:
            # the outer sink, so close() flushes undecided traces first
            sink = SamplingSpanSink(sink, rate=obs.trace_sample,
                                    keep_slow_ms=obs.trace_keep_slow_ms, registry=registry)
        # a per-run id prefix: the sink appends, and a restarted process
        # would otherwise re-issue t000001... into the same file
        tracer = Tracer(sink=sink, prefix=f"{os.getpid():x}.{int(time.time()) & 0xFFFFFF:x}.")
    snapshot_writer = None
    if obs.snapshot_every_s is not None or obs.snapshot_path is not None:
        snapshot_writer = SnapshotWriter(
            registry, _resolve(obs.snapshot_path or "metrics_snapshot.json"),
            every_s=obs.snapshot_every_s,
            # the build ledger's table and the process-wide registry (where
            # the ledger's families and the device gauges live) ride along
            extra=lambda: {"compile_ledger": default_ledger().snapshot(),
                           "process_metrics": default_registry().snapshot()},
        )
    slo_monitor = None
    if obs.slo.enabled:
        slo_monitor = SLOMonitor(
            obs.slo.policy(), registry=registry,
            tracer=None,  # run_serve swaps in its tracer
            fast_window_s=obs.slo.fast_window_s, slow_window_s=obs.slo.slow_window_s,
            breach_burn_rate=obs.slo.burn_rate,
        )
    flight_recorder = None
    if obs.incident.dir is not None:
        incident_dir = obs.incident.dir
        if not os.path.isabs(incident_dir):
            incident_dir = os.path.join(root, incident_dir)
        flight_recorder = FlightRecorder(
            incident_dir, tracer=tracer, registry=registry, cooldown_s=obs.incident.cooldown_s,
            max_bundles=obs.incident.max_bundles, keep_spans=obs.incident.keep_spans,
        )
    elif obs.incident != type(obs.incident)() or any(
            k.startswith("obs.incident.") for k in (passed or ())):
        raise SystemExit("--obs.incident.* tunes the incident flight recorder, which is "
                         "enabled by setting --obs.incident.dir (docs/observability.md)")
    timeline = None
    timeline_export = None
    if obs.timeline.enabled:
        if obs.timeline.swap_gbps <= 0:
            raise SystemExit(f"--obs.timeline.swap_gbps must be > 0, got {obs.timeline.swap_gbps}")
        timeline = StepTimeline(cap=obs.timeline.steps, registry=registry)
        if obs.timeline.export is not None:
            timeline_export = _resolve(obs.timeline.export)
    elif obs.timeline != type(obs.timeline)() or any(
            k.startswith("obs.timeline.") for k in (passed or ())):
        raise SystemExit("--obs.timeline.* tunes the scheduler step timeline, which is "
                         "enabled by setting --obs.timeline.steps (docs/observability.md)")
    trigger = None
    if obs.profile_on_regress_factor is not None:
        trigger = ProfilerTrigger(os.path.join(root, "profile_regress"),
                                  factor=obs.profile_on_regress_factor)
    if slo_monitor is not None:
        # a breach arms the trigger and dumps an incident bundle
        slo_monitor.profiler_trigger = trigger
        slo_monitor.flight_recorder = flight_recorder
    return {
        "registry": registry, "tracer": tracer, "sink": sink,
        "snapshot_writer": snapshot_writer, "trigger": trigger, "slo_monitor": slo_monitor,
        "flight_recorder": flight_recorder, "timeline": timeline,
        "timeline_export": timeline_export,
    }


def _run_obs(argv: Sequence[str]) -> str:
    """``obs report|incident|timeline``: the offline analyzers over what a
    run's telemetry wrote; no checkpoint, no model, no card."""
    import json as _json

    from perceiver_io_tpu_torch.observability import report as report_mod

    if len(argv) < 1 or argv[0] not in ("report", "incident", "timeline"):
        raise SystemExit(
            "usage: obs report --events <events.jsonl> "
            "[--snapshot <snapshot.json>] [--top N] [--json true]\n"
            "       obs incident --bundle <incident dir> "
            "[--top N] [--json true]\n"
            "       obs timeline --timeline <timeline.jsonl> "
            "[--events <events.jsonl>] [--snapshot <snapshot.json>] "
            "[--trace_out <trace.json>] [--top N] [--json true]"
        )
    if argv[0] == "incident":
        vals = _parse_dotted(argv[1:], {"bundle": str, "top": int, "json": bool})
        if "bundle" not in vals:
            raise SystemExit("obs incident requires --bundle <incident dir>")
        try:
            text = report_mod.run_incident(vals["bundle"], top=int(vals.get("top", 8)),
                                           as_json=bool(vals.get("json", False)))
        except _json.JSONDecodeError as e:  # a ValueError: caught first, with the path
            raise SystemExit(f"obs incident: bundle manifest is not valid JSON "
                             f"({vals.get('bundle')}: {e})")
        except (OSError, ValueError) as e:
            raise SystemExit(f"obs incident: {e}")
        print(text)
        return text
    if argv[0] == "timeline":
        vals = _parse_dotted(argv[1:], {"timeline": str, "events": str, "snapshot": str,
                                        "trace_out": str, "top": int, "json": bool})
        if "timeline" not in vals:
            raise SystemExit("obs timeline requires --timeline <timeline.jsonl> "
                             "(a --obs.timeline.export file)")
        try:
            text = report_mod.run_timeline(
                vals["timeline"], vals.get("events"), vals.get("snapshot"),
                trace_out=vals.get("trace_out"), top=int(vals.get("top", 20)),
                as_json=bool(vals.get("json", False)))
        except _json.JSONDecodeError as e:
            raise SystemExit(f"obs timeline: artifact is not valid JSON "
                             f"({vals.get('timeline')}: {e})")
        except (OSError, ValueError) as e:
            raise SystemExit(f"obs timeline: {e}")
        print(text)
        return text
    vals = _parse_dotted(argv[1:], {"events": str, "snapshot": str, "top": int, "json": bool})
    if "events" not in vals:
        raise SystemExit("obs report requires --events <events.jsonl>")
    try:
        text = report_mod.run(vals["events"], vals.get("snapshot"), top=int(vals.get("top", 20)),
                              as_json=bool(vals.get("json", False)))
    except OSError as e:
        raise SystemExit(f"obs report: {e}")
    except _json.JSONDecodeError as e:
        raise SystemExit(f"obs report: --snapshot is not valid JSON ({vals.get('snapshot')}: {e})")
    print(text)
    return text


@dataclasses.dataclass
class ServeArgs:
    """``--serve.*`` flags for the ``serve`` subcommand: text generation over
    a ``save_pretrained`` or trainer checkpoint (the JAX CLI's fields and
    defaults; docs/serving.md describes each)."""

    #: prompts file, one per line; omitted = read prompts from stdin
    prompts: Optional[str] = None
    max_new_tokens: int = 64
    num_latents: int = 1
    temperature: float = 0.0  # greedy by default — deterministic serving
    #: ``bucket`` packs whole micro-batches per generation; ``slots`` is
    #: token-granular continuous batching over persistent decode slots
    engine: str = "bucket"
    #: persistent decode slots for ``--serve.engine=slots``
    slots: int = 8
    #: chunked prefill for the slot engine (None = off)
    prefill_chunk: Optional[int] = None
    #: boundary-phase decode strategy: auto | cached | recompute
    decode_strategy: str = "auto"
    #: JSON path persisting the measured strategies' verdicts
    decode_strategy_file: Optional[str] = None
    #: slot-engine KV layout: auto | dense | paged | paged_int8
    kv_layout: str = "auto"
    #: token positions per KV pool block (paged layouts)
    kv_block_size: Optional[int] = None
    #: usable KV pool capacity in blocks (paged layouts)
    kv_blocks: Optional[int] = None
    #: cross-request prefix sharing: auto | on | off (on needs a paged layout)
    prefix_cache: str = "auto"
    #: self-draft speculative decoding: auto | off | k<K>d<D>
    speculation: str = "auto"
    #: preemption for the paged slot engine: recompute | swap | auto (None = off)
    preemption: Optional[str] = None
    #: decode headroom blocks granted beyond the prompt at lazy admission
    admit_headroom_blocks: int = 0
    #: host-swap link prior in GB/s (preemption swap | auto)
    swap_gbps: Optional[float] = None
    #: prompt-length bucket grid; default = powers of two up to the context
    prompt_buckets: Optional[typing.Tuple[int, ...]] = None
    #: micro-batch size grid (``bucket`` engine; ignored by ``slots``)
    batch_buckets: typing.Tuple[int, ...] = (1, 2, 4, 8)
    #: drive every bucket before accepting traffic
    warmup: bool = True
    #: seeds the engine's ``torch.Generator`` on the serving device
    seed: int = 0
    #: append the engine stats JSON line to stdout after the results
    stats: bool = True
    #: bounded queue depth (None = unbounded)
    max_queue: Optional[int] = None
    #: per-request deadline in seconds
    deadline_s: Optional[float] = None
    #: engine replicas behind a supervised fleet router
    replicas: int = 1
    failover: bool = True
    step_timeout_s: Optional[float] = None
    http: HttpArgs = dataclasses.field(default_factory=HttpArgs)
    autoscale: AutoscaleArgs = dataclasses.field(default_factory=AutoscaleArgs)
    mesh: MeshServeArgs = dataclasses.field(default_factory=MeshServeArgs)


def _serve_mode(flag: str, flag_value: str, env_var: str, modes: tuple) -> str:
    """Resolve a ``--serve.*`` strategy flag against its env override: an
    explicit value beats the env var, the ``auto`` default defers to it (and
    the engine then to the measured registry)."""
    import os

    if flag_value not in modes:
        raise SystemExit(f"{flag} must be one of {'|'.join(modes)}, got {flag_value!r}")
    if flag_value != "auto":
        return flag_value
    env_mode = os.environ.get(env_var)
    if not env_mode:
        return flag_value
    if env_mode not in modes:
        raise SystemExit(f"{env_var} must be one of {'|'.join(modes)}, got {env_mode!r}")
    return env_mode


def _serve_decode_mode(flag_value: str) -> str:
    """``--serve.decode_strategy`` against ``PERCEIVER_DECODE_STRATEGY``."""
    from perceiver_io_tpu_torch.inference import decode_strategy as strategy_mod

    return _serve_mode("--serve.decode_strategy", flag_value, strategy_mod.ENV_VAR,
                       strategy_mod.MODES)


def _serve_kv_layout(flag_value: str) -> str:
    """``--serve.kv_layout`` against ``PERCEIVER_KV_LAYOUT``."""
    from perceiver_io_tpu_torch.inference import decode_strategy as strategy_mod

    return _serve_mode("--serve.kv_layout", flag_value, strategy_mod.ENV_KV_LAYOUT,
                       strategy_mod.KV_LAYOUTS)


def _serve_prefix_cache(flag_value: str) -> str:
    """``--serve.prefix_cache`` against ``PERCEIVER_PREFIX_CACHE``."""
    from perceiver_io_tpu_torch.inference import decode_strategy as strategy_mod

    return _serve_mode("--serve.prefix_cache", flag_value, strategy_mod.ENV_PREFIX_CACHE,
                       strategy_mod.PREFIX_CACHE_MODES)


def _serve_speculation(flag_value: str) -> str:
    """``--serve.speculation`` against ``PERCEIVER_SPECULATION``."""
    from perceiver_io_tpu_torch.inference import decode_strategy as strategy_mod

    return _serve_mode("--serve.speculation", flag_value, strategy_mod.ENV_SPECULATION,
                       strategy_mod.SPECULATION_MODES)


# -- the CLI ---------------------------------------------------------------
@dataclasses.dataclass
class ModelFamily:
    """Declarative description of one trainable model family.

    :param build_model: ``(model_cfg, data_module, *, device, seed) ->
        nn.Module``, weights made from ``seed`` (``--trainer.seed``).
    :param make_loss: ``(model, model_cfg) -> loss_fn`` for the trainer.
    :param link: ``(data_module, values dict) -> None`` — mutate dotted model
        values from data properties before the model config is built.
    :param initial_params: ``(model, model_cfg, data_module) -> None`` —
        warm-start part of the fresh model in place (the text classifier's
        encoder from a masked LM); not run under ``--ckpt``/``--params``,
        which load the whole model.
    :param frozen_prefixes: ``model_cfg -> tuple`` of flax parameter-path
        prefixes left out of the optimizer (``make_optimizer``).

    JAX's ``init_args`` is not needed (a module makes its weights without a
    batch).
    """

    name: str
    config_class: type
    data_registry: Dict[str, Callable]
    build_model: Callable
    make_loss: Callable
    nested: Optional[Dict[str, type]] = None
    link: Optional[Callable] = None
    initial_params: Optional[Callable] = None
    frozen_prefixes: Optional[Callable] = None
    defaults: Optional[Dict[str, Any]] = None


def _wants_help(argv: Sequence[str]) -> bool:
    """True when a standalone ``-h``/``--help`` appears. Tokens consumed as
    the *value* of a space-separated flag don't count."""
    expecting_value = False
    for tok in argv:
        if expecting_value:
            expecting_value = False
            continue
        if tok in ("-h", "--help"):
            return True
        if tok.startswith("--") and "=" not in tok:
            expecting_value = True
    return False


def _parse_dotted(argv: Sequence[str], known: Dict[str, Any]) -> Dict[str, Any]:
    values: Dict[str, Any] = {}
    i = 0
    argv = list(argv)
    while i < len(argv):
        arg = argv[i]
        if not arg.startswith("--"):
            raise SystemExit(f"unexpected argument {arg!r}")
        if "=" in arg:
            key, text = arg[2:].split("=", 1)
        else:
            key = arg[2:]
            if i + 1 >= len(argv):
                raise SystemExit(f"missing value for --{key}")
            text = argv[i + 1]
            i += 1
        if key not in known:
            raise SystemExit(
                f"unknown flag --{key}; known flags include: "
                + ", ".join(sorted(known)[:12])
                + ", ..."
            )
        values[key] = _parse_value(text, known[key]) if isinstance(text, str) else text
        i += 1
    return values


#: the top-level flags every subcommand but ``obs`` takes
_TOP_FLAGS = {"ckpt": str, "params": str, "device": str}


class CLI:
    """fit/validate/test/preproc/serve driver for one :class:`ModelFamily`."""

    def __init__(self, family: ModelFamily):
        self.family = family

    # -- flag space --------------------------------------------------------
    def _known_flags(self, data_cls) -> Dict[str, Any]:
        from perceiver_io_tpu_torch.training.trainer import TrainerConfig

        known: Dict[str, Any] = {"config": str, "data": str, **_TOP_FLAGS}
        known.update(flag_specs(self.family.config_class, "model", self.family.nested))
        known.update(_ctor_flag_specs(data_cls, "data"))
        known.update(flag_specs(TrainerConfig, "trainer"))
        known.update(flag_specs(OptimizerArgs, "optimizer"))
        known.update(flag_specs(LRSchedulerArgs, "lr_scheduler"))
        known.update(flag_specs(ObservabilityArgs, "obs"))
        known.update(flag_specs(MeshConfig, "mesh"))
        return known

    def main(self, argv: Optional[Sequence[str]] = None) -> Any:
        argv = list(sys.argv[1:] if argv is None else argv)
        if not argv or _wants_help(argv):
            self._print_help()
            return None
        subcommand = argv[0]
        if subcommand not in ("fit", "validate", "test", "preproc", "serve", "obs"):
            raise SystemExit(
                f"unknown subcommand {subcommand!r} "
                "(fit|validate|test|preproc|serve|obs)"
            )
        if subcommand == "obs":
            return _run_obs(argv[1:])
        if subcommand == "serve":
            # serve needs no datamodule: the checkpoint's embedded config
            # picks the model, and prompts come from a file or stdin.
            known = dict(_TOP_FLAGS)
            known.update(flag_specs(ServeArgs, "serve"))
            known.update(flag_specs(ObservabilityArgs, "obs"))
            return self.run_serve(_parse_dotted(argv[1:], known))

        # data module choice first (its ctor defines the --data.* space)
        data_name = None
        for arg in argv[1:]:
            if arg.startswith("--data="):
                data_name = arg.split("=", 1)[1]
            elif arg == "--data":
                idx = argv.index(arg)
                data_name = argv[idx + 1] if idx + 1 < len(argv) else None
        registry = self.family.data_registry
        if data_name is None:
            data_name = next(iter(registry))
        if data_name not in registry:
            raise SystemExit(
                f"unknown data module {data_name!r}; choose from {sorted(registry)}"
            )
        data_cls = registry[data_name]

        known = self._known_flags(data_cls)
        values = dict(self.family.defaults or {})
        cli_values = _parse_dotted(argv[1:], known)
        if "config" in cli_values:
            import yaml

            with open(cli_values.pop("config")) as fh:
                for key, val in (yaml.safe_load(fh) or {}).items():
                    values[key] = val
        values.update(cli_values)
        values.pop("data", None)
        return self.run(subcommand, data_cls, values)

    # -- execution ---------------------------------------------------------
    def run(self, subcommand: str, data_cls, values: Dict[str, Any]) -> Any:
        import json

        from perceiver_io_tpu_torch._device import resolve_device
        from perceiver_io_tpu_torch.parallel import collectives
        from perceiver_io_tpu_torch.training.checkpoint import load_pretrained
        from perceiver_io_tpu_torch.training.lrs import constant_with_warmup, cosine_with_warmup
        from perceiver_io_tpu_torch.training.optim import make_optimizer
        from perceiver_io_tpu_torch.training.trainer import Trainer, TrainerConfig

        if any(k.startswith("obs.slo.") for k in values):
            # SLO targets judge serving token latency; a fit has none
            raise SystemExit(
                "--obs.slo.* applies to the serve subcommand (SLO targets "
                "monitor serving token latency; docs/observability.md)"
            )
        if any(k.startswith("obs.timeline.") for k in values):
            raise SystemExit(
                "--obs.timeline.* applies to the serve subcommand (the "
                "step timeline records scheduler passes; "
                "docs/observability.md)"
            )
        device = resolve_device(values.get("device", "cuda"))
        mesh = None if subcommand == "preproc" else _training_mesh(values, device)
        if mesh is not None:
            device = mesh.device
        data_kwargs = {
            k.split(".", 1)[1]: v for k, v in values.items() if k.startswith("data.")
        }
        dm = data_cls(**data_kwargs)
        # under a mesh rank 0 writes the data cache first, the others read it
        world = None if mesh is None else mesh.group(*mesh.axis_names)
        if mesh is not None and mesh.rank != 0:
            collectives.barrier(world)
        dm.prepare_data()
        if mesh is not None and mesh.rank == 0:
            collectives.barrier(world)
        if subcommand == "preproc":
            return None
        dm.setup()

        if self.family.link is not None:
            self.family.link(dm, values)
        model_cfg = build_dataclass(
            self.family.config_class, values, "model", self.family.nested
        )
        trainer_cfg = build_dataclass(TrainerConfig, values, "trainer")
        opt = build_dataclass(OptimizerArgs, values, "optimizer")
        lrs = build_dataclass(LRSchedulerArgs, values, "lr_scheduler")

        steps = lrs.training_steps or trainer_cfg.max_steps
        if lrs.name == "cosine":
            schedule = cosine_with_warmup(
                opt.lr, warmup_steps=lrs.warmup_steps,
                training_steps=steps, min_fraction=lrs.min_fraction,
            )
        elif lrs.name == "constant":
            schedule = constant_with_warmup(opt.lr, warmup_steps=lrs.warmup_steps)
        else:
            schedule = None
        tx = make_optimizer(
            schedule if schedule is not None else opt.lr,
            optimizer=opt.optimizer,
            weight_decay=opt.weight_decay,
            b1=opt.b1,
            b2=opt.b2,
            frozen_prefixes=(self.family.frozen_prefixes(model_cfg)
                             if self.family.frozen_prefixes is not None else ()),
        )
        # JAX's model.init(PRNGKey(trainer.seed)): the weights come from the
        # trainer's seed, unless a checkpoint replaces them
        model = self.family.build_model(model_cfg, dm, device=device, seed=trainer_cfg.seed)
        if values.get("ckpt") or values.get("params"):
            # full-model warm start from a save_pretrained dir or a trainer
            # checkpoint dir (``--ckpt`` is the evaluation-time spelling)
            initial, _ = load_pretrained(values.get("ckpt") or values["params"])
            model.load_state_dict(initial, strict=True)
        elif self.family.initial_params is not None:
            self.family.initial_params(model, model_cfg, dm)

        obs = build_dataclass(ObservabilityArgs, values, "obs")
        if mesh is None or mesh.rank == 0:
            kit = _obs_kit(obs, trainer_cfg.default_root_dir, passed=set(values))
        else:  # rank 0 alone writes the run directory
            kit = dict.fromkeys(("registry", "tracer", "trigger", "snapshot_writer", "sink"))
        trainer = Trainer(
            trainer_cfg,
            self.family.make_loss(model, model_cfg),
            tx,
            model_config=model_cfg,
            lr_schedule=schedule,
            device=device,
            registry=kit["registry"],
            tracer=kit["tracer"],
            profiler_trigger=kit["trigger"],
            snapshot_writer=kit["snapshot_writer"],
            mesh=mesh,
        )
        try:
            if subcommand in ("validate", "test"):
                trainer.setup_state(model)
                loader = dm.test_dataloader() if subcommand == "test" else dm.val_dataloader()
                metrics = trainer.test(loader) if subcommand == "test" else trainer.validate(loader)
                if trainer.is_main_process:
                    print(json.dumps({k: round(float(v), 6) for k, v in metrics.items()}))
                return metrics

            return trainer.fit(model, dm.train_dataloader(), val_data=dm.val_dataloader)
        finally:
            # validate/test never reach fit's own forced write
            if kit["snapshot_writer"] is not None:
                kit["snapshot_writer"].maybe_write(force=True)
            if kit["sink"] is not None:
                kit["sink"].close()

    # -- serving -----------------------------------------------------------
    def run_serve(self, values: Dict[str, Any]) -> list:
        """``serve --ckpt <dir>``: text generation over a saved model —
        prompts (file or stdin) → one JSON line per completion, plus a final
        engine-stats line.

        An infeasible prompt (empty / longer than the largest bucket) becomes
        a per-line ``{"prompt": ..., "error": ...}`` record instead of
        aborting the run; a bounded queue (``--serve.max_queue``)
        backpressures by draining before resubmitting; timed-out or failed
        requests surface their status per line. Every line carries its
        request's ``trace_id``: the engine always gets a tracer (without
        ``--obs.events_path`` its spans stay in memory).
        """
        import os
        import time

        import torch

        from perceiver_io_tpu_torch._device import resolve_device
        from perceiver_io_tpu_torch.data.text.tokenizers import ByteTokenizer
        from perceiver_io_tpu_torch.inference import decode_strategy as strategy_mod
        from perceiver_io_tpu_torch.inference.generate import GenerationConfig
        from perceiver_io_tpu_torch.inference.samplers import SamplingConfig
        from perceiver_io_tpu_torch.models import model_for_config
        from perceiver_io_tpu_torch.models.text.clm import CausalLanguageModel
        from perceiver_io_tpu_torch.observability import Tracer, default_ledger
        from perceiver_io_tpu_torch.serving.buckets import BucketTable
        from perceiver_io_tpu_torch.serving.engine import ServingEngine
        from perceiver_io_tpu_torch.serving.slots import PREEMPTION_MODES, SlotServingEngine
        from perceiver_io_tpu_torch.training.checkpoint import load_pretrained

        ckpt = values.get("ckpt") or values.get("params")
        if not ckpt:
            raise SystemExit("serve requires --ckpt <save_pretrained dir>")
        args = build_dataclass(ServeArgs, values, "serve")
        mesh_spec = _serve_mesh(values, args)
        device = resolve_device(values.get("device", "cuda"))
        if mesh_spec is not None:
            from perceiver_io_tpu_torch.parallel import multihost
            from perceiver_io_tpu_torch.serving.sharding import DRIVER_RANK

            multihost.initialize(device=values.get("device", "cuda"))
            device = multihost.rank_device(values.get("device", "cuda"))
            if multihost.process_index() != DRIVER_RANK:
                # a follower: its shard of each engine, no scheduler, no output
                return self._serve_follow(ckpt, mesh_spec, device)
        obs = build_dataclass(ObservabilityArgs, values, "obs")
        kit = _obs_kit(obs, os.getcwd(), passed=set(values))
        tracer = kit["tracer"] or Tracer()
        if kit["slo_monitor"] is not None:
            kit["slo_monitor"].tracer = tracer
        if kit["flight_recorder"] is not None:
            kit["flight_recorder"].tracer = tracer
        # the ledger's kernel builds stream into events.jsonl as
        # ``ledger.compile`` events, so ``obs report`` over the events alone
        # still carries the build table
        ledger = default_ledger()
        detach_ledger = ledger.attach(
            lambda rec: tracer.event(
                "ledger.compile", site=rec["site"], compile_ms=rec["compile_ms"],
                flops=rec["flops"], bytes_accessed=rec["bytes_accessed"],
                argument_bytes=rec["argument_bytes"], output_bytes=rec["output_bytes"],
                temp_bytes=rec["temp_bytes"], retrace=rec["retrace"],
                reasons=",".join(rec["retrace_reasons"]),
                bucket_shape=rec["components"].get("bucket_shape"),
            )
        ) if kit["sink"] is not None else (lambda: None)
        mesh_alloc = None
        try:
            state, model_cfg = load_pretrained(ckpt)
            if model_cfg is None:
                raise SystemExit(f"{ckpt} has no embedded model config")
            model = model_for_config(model_cfg, device=device)
            if not isinstance(model, CausalLanguageModel):
                # The decode side is the byte tokenizer; a non-text AR family
                # (e.g. symbolic audio) would sample ids the tokenizer cannot
                # decode — fail fast instead of mid-stream.
                raise SystemExit(
                    "serve currently supports text CLM checkpoints (byte "
                    f"tokenizer); got {type(model).__name__}"
                )
            model.load_state_dict(state, strict=True)
            model.eval()
            del state
            if mesh_spec is not None:
                from perceiver_io_tpu_torch.serving.sharding import MeshGroupAllocator

                # one allocator hands each spawn the first FREE disjoint
                # rank group: initial replicas, crash rebuilds (the crashed
                # group frees for its rebuild), scale-ups
                mesh_alloc = MeshGroupAllocator(mesh_spec, device=device)

            table = BucketTable.for_model(model)
            if args.prompt_buckets or tuple(args.batch_buckets) != (1, 2, 4, 8):
                table = BucketTable(
                    prompt_lens=tuple(args.prompt_buckets or table.prompt_lens),
                    batch_sizes=tuple(args.batch_buckets),
                )
            tok = ByteTokenizer(padding_side="left")
            gen_cfg = GenerationConfig(
                max_new_tokens=args.max_new_tokens,
                num_latents=args.num_latents,
                pad_token_id=tok.pad_token_id or 0,
                eos_token_id=tok.eos_token_id,
                sampling=SamplingConfig(temperature=args.temperature),
            )
            if args.engine not in ("bucket", "slots"):
                raise SystemExit(
                    f"--serve.engine must be 'bucket' or 'slots', got {args.engine!r}"
                )
            decode_mode = _serve_decode_mode(args.decode_strategy)
            if args.decode_strategy_file:
                # persisted verdicts short-circuit the warmup autotune; fresh
                # verdicts measured this run are written back on warmup
                strategy_mod.load_registry(args.decode_strategy_file)
            if args.replicas < 1:
                raise SystemExit(
                    f"--serve.replicas must be >= 1, got {args.replicas}"
                )
            if args.preemption is not None and args.preemption not in PREEMPTION_MODES:
                raise SystemExit(
                    "--serve.preemption must be one of "
                    f"{PREEMPTION_MODES}, got {args.preemption!r}"
                )
            if args.admit_headroom_blocks < 0:
                raise SystemExit(
                    "--serve.admit_headroom_blocks must be >= 0, got "
                    f"{args.admit_headroom_blocks}"
                )
            if args.admit_headroom_blocks and args.preemption is None:
                raise SystemExit(
                    "--serve.admit_headroom_blocks applies with "
                    "--serve.preemption (strict reservations already "
                    "cover the worst case)"
                )
            if args.swap_gbps is not None:
                if args.preemption not in ("swap", "auto"):
                    raise SystemExit(
                        "--serve.swap_gbps applies with "
                        "--serve.preemption=swap|auto (no other mode "
                        "ships KV pages over the host link)"
                    )
                if args.swap_gbps <= 0:
                    raise SystemExit(
                        f"--serve.swap_gbps must be > 0, got "
                        f"{args.swap_gbps}"
                    )
            autoscale = args.autoscale
            if autoscale.max is None and any(k.startswith("serve.autoscale.") for k in values):
                # tuning an autoscaler that was never enabled must not
                # silently do nothing
                raise SystemExit(
                    "--serve.autoscale.* tunes the fleet autoscaler, which "
                    "is enabled by setting --serve.autoscale.max"
                )
            if autoscale.max is not None:
                if autoscale.max < max(autoscale.min, args.replicas):
                    raise SystemExit(
                        f"--serve.autoscale.max ({autoscale.max}) must be >= "
                        f"max(--serve.autoscale.min ({autoscale.min}), "
                        f"--serve.replicas ({args.replicas}))"
                    )
                if autoscale.scale_up_slots is not None and args.engine != "slots":
                    raise SystemExit(
                        "--serve.autoscale.scale_up_slots applies to "
                        "--serve.engine=slots (the bucket engine has no "
                        "persistent decode slots to resize)"
                    )
            # the autoscaler drives add/remove_replica, so enabling it builds
            # the fleet layer even at one replica
            fleet_mode = args.replicas > 1 or autoscale.max is not None
            if not fleet_mode:
                if args.step_timeout_s is not None:
                    raise SystemExit(
                        "--serve.step_timeout_s applies to --serve.replicas > 1 "
                        "(hang detection is fleet supervision; a single engine "
                        "is driven directly)"
                    )
                if not args.failover:
                    print(
                        "[serve] --serve.failover=false is a no-op with "
                        "--serve.replicas=1 (no fleet layer, so there is no "
                        "failover to disable)",
                        file=sys.stderr, flush=True,
                    )
            flight_recorder = kit["flight_recorder"]
            engine_kwargs = dict(
                # with a fleet, admission (bounded queue, deadlines) is the
                # router's; each engine enforces the remaining deadline it is
                # handed at dispatch
                max_queue=None if fleet_mode else args.max_queue,
                default_deadline_s=None if fleet_mode else args.deadline_s,
                # fleet replicas keep private registries, so serve_stats'
                # per-replica engine stats are each one replica's; the kit's
                # registry carries the fleet_* families
                registry=None if fleet_mode else kit["registry"],
                tracer=tracer,
                # the slot engine feeds each decode step's ms, the bucket
                # engine each batch's; an armed trigger captures the next
                profiler_trigger=kit["trigger"],
                decode_strategy=decode_mode,
                device=device,
            )
            kv_mode = _serve_kv_layout(args.kv_layout)
            prefix_mode = _serve_prefix_cache(args.prefix_cache)
            spec_mode = _serve_speculation(args.speculation)
            if (
                args.engine == "slots"
                and args.warmup
                and spec_mode == "auto"
                and strategy_mod.lookup_speculation(model) is None
            ):
                # measure once, memoize: A/B each draft geometry against "off"
                # on the probe workload; a persisted
                # --serve.decode_strategy_file skips this on the next boot
                t0 = time.monotonic()
                spec_mode = strategy_mod.autotune_speculation(model)
                print(
                    f"[serve] speculation autotune picked {spec_mode!r} in "
                    f"{time.monotonic() - t0:.1f}s", file=sys.stderr,
                    flush=True,
                )
            if args.engine == "slots":
                # swap modes let the engine resolve the link rate itself;
                # other modes keep the post-mortem denominator at the
                # timeline flag's default, as in JAX
                if args.preemption in ("swap", "auto"):
                    link_gbps = args.swap_gbps
                else:
                    link_gbps = obs.timeline.swap_gbps

                def build():
                    return SlotServingEngine(
                        model, gen_cfg, table, slots=args.slots,
                        prefill_chunk=args.prefill_chunk,
                        kv_layout=kv_mode, kv_block_size=args.kv_block_size,
                        kv_blocks=args.kv_blocks, prefix_cache=prefix_mode,
                        preemption=args.preemption,
                        admit_headroom_blocks=args.admit_headroom_blocks,
                        speculation=spec_mode,
                        swap_link_gbps=link_gbps,
                        mesh=None if mesh_alloc is None else mesh_alloc.acquire(),
                        # each engine (a fleet rebuild or spawn too) gets a
                        # generator seeded alike, as JAX's PRNGKey(seed)
                        generator=torch.Generator(device=device).manual_seed(args.seed),
                        **engine_kwargs,
                    )
            else:
                if args.prefill_chunk is not None:
                    raise SystemExit(
                        "--serve.prefill_chunk applies to --serve.engine=slots "
                        "(the bucket engine has no resident decode to interleave)"
                    )
                # checked on the RAW flags, not the env-resolved mode: a
                # machine-wide PERCEIVER_KV_LAYOUT set for slot deployments
                # must not break unrelated bucket-engine jobs
                if args.kv_layout != "auto" or args.kv_block_size is not None \
                        or args.kv_blocks is not None:
                    raise SystemExit(
                        "--serve.kv_layout/--serve.kv_block_size/"
                        "--serve.kv_blocks apply to --serve.engine=slots "
                        "(the bucket engine has no persistent KV state to page)"
                    )
                if args.prefix_cache != "auto":
                    raise SystemExit(
                        "--serve.prefix_cache applies to --serve.engine=slots "
                        "with the paged KV layout (the bucket engine has no "
                        "block tables to share)"
                    )
                if args.preemption is not None \
                        or args.admit_headroom_blocks != 0 \
                        or args.swap_gbps is not None:
                    raise SystemExit(
                        "--serve.preemption/--serve.admit_headroom_blocks/"
                        "--serve.swap_gbps apply to --serve.engine=slots "
                        "with a paged KV layout (the bucket engine has no "
                        "page pool to preempt from)"
                    )
                if args.speculation != "auto":
                    raise SystemExit(
                        "--serve.speculation applies to --serve.engine=slots "
                        "(the bucket engine has no resident decode loop to "
                        "draft ahead of)"
                    )

                def build():
                    return ServingEngine(
                        model, gen_cfg, table,
                        generator=torch.Generator(device=device).manual_seed(args.seed),
                        **engine_kwargs)

            def make_engine():
                # inside the factory: a fleet's rebuilds and spawns keep the
                # pool-exhaustion seam and the one shared timeline ring
                eng = build()
                eng.flight_recorder = flight_recorder
                eng.timeline = kit["timeline"]
                return eng

            if fleet_mode:
                from perceiver_io_tpu_torch.serving.autoscaler import FleetAutoscaler
                from perceiver_io_tpu_torch.serving.fleet import FleetRouter

                # the fleet mirrors the engine request surface, so the prompt
                # loop and the gateway drive it unchanged
                engine = FleetRouter(
                    [make_engine] * args.replicas,
                    max_pending=args.max_queue,
                    default_deadline_s=args.deadline_s,
                    failover=args.failover,
                    step_timeout_s=args.step_timeout_s,
                    registry=kit["registry"],
                    tracer=tracer,
                    # a sustained burn tightens the fleet's admission
                    slo_monitor=kit["slo_monitor"],
                    slo_shed_factor=obs.slo.shed_factor,
                    # replica failures and breaker opens dump bundles
                    flight_recorder=flight_recorder,
                )
                if autoscale.max is not None:
                    # installs itself on the router; every fleet step polls it
                    FleetAutoscaler(
                        engine,
                        max_replicas=autoscale.max,
                        min_replicas=autoscale.min,
                        up_cooldown_s=autoscale.up_cooldown_s,
                        down_cooldown_s=autoscale.down_cooldown_s,
                        up_evidence=autoscale.up_evidence,
                        down_evidence=autoscale.down_evidence,
                        queue_high=autoscale.queue_high,
                        queue_low=autoscale.queue_low,
                        scale_up_slots=autoscale.scale_up_slots,
                        tracer=tracer,
                    )
            else:
                engine = make_engine()
                if kit["slo_monitor"] is not None:
                    # the engine mirrors every TTFT/ITL sample into the
                    # monitor; the error rate diffs the serving_* counters
                    engine.latency_sink = kit["slo_monitor"].sink
                    kit["slo_monitor"].watch_counters(kit["registry"].counters, prefix="serving")
            if flight_recorder is not None:
                # the state each incident bundle captures (the fleet's health
                # embeds every replica's)
                flight_recorder.add_source("health", engine.health)
                if kit["slo_monitor"] is not None:
                    flight_recorder.add_source("slo", kit["slo_monitor"].stats)
                autoscaler = getattr(engine, "autoscaler", None)
                if autoscaler is not None:
                    flight_recorder.add_source("autoscaler", autoscaler.stats)
                if fleet_mode:
                    # read through the router at dump time: a closure over one
                    # engine would keep a retired replica's pool alive
                    flight_recorder.add_source("kv_pool", lambda: {
                        str(r.replica_id): r.engine._pool.stats() for r in engine.replicas
                        if getattr(r.engine, "_pool", None) is not None})
                elif getattr(engine, "_pool", None) is not None:
                    flight_recorder.add_source("kv_pool", engine._pool.stats)
                if kit["timeline"] is not None:
                    flight_recorder.add_source("timeline", kit["timeline"].summary)
                if fleet_mode:
                    flight_recorder.add_source("preemption_postmortems", lambda: {
                        str(r.replica_id): r.engine.postmortems() for r in engine.replicas
                        if hasattr(r.engine, "postmortems")})
                elif hasattr(engine, "postmortems"):
                    flight_recorder.add_source("preemption_postmortems", engine.postmortems)
            if args.warmup:
                t0 = time.monotonic()
                driven = engine.warmup()
                print(
                    f"[serve] warmup drove {driven} steps in "
                    f"{time.monotonic() - t0:.1f}s", file=sys.stderr, flush=True,
                )
                if args.decode_strategy_file and (
                    decode_mode == "auto"
                    or (args.engine == "slots" and (
                        kv_mode == "auto" or args.speculation == "auto"
                        or args.preemption in ("swap", "auto")
                    ))
                ):
                    strategy_mod.save_registry(args.decode_strategy_file)

            if args.http.port is not None:
                # gateway mode: requests arrive on sockets and tokens stream
                # back as they decode
                if args.prompts:
                    raise SystemExit(
                        "--serve.prompts applies to the batch loop; with "
                        "--serve.http.port set, prompts arrive over "
                        "POST /v1/generate"
                    )
                return self._serve_http(engine, tok, args, kit)

            if args.prompts:
                with open(args.prompts) as fh:
                    prompts = [line.rstrip("\n") for line in fh if line.strip()]
            else:
                prompts = [line.rstrip("\n") for line in sys.stdin if line.strip()]
            if not prompts:
                raise SystemExit("serve: no prompts (empty file/stdin)")

            return self._serve_prompts(engine, tok, prompts, args, kit)
        finally:
            if mesh_alloc is not None:
                mesh_alloc.stop()  # the followers' loops end
            # swap transfers calibrate the per-platform link rate during
            # serving: persist the measured value for the next process
            if args.decode_strategy_file \
                    and args.preemption in ("swap", "auto"):
                strategy_mod.save_registry(args.decode_strategy_file)
            # even an exception mid-drain leaves a final snapshot, the
            # timeline on disk and a closed events file
            detach_ledger()
            ledger.update_device_gauges()
            if kit["snapshot_writer"] is not None:
                kit["snapshot_writer"].maybe_write(force=True)
            if kit["timeline_export"] is not None and kit["timeline"] is not None:
                n = kit["timeline"].write_jsonl(kit["timeline_export"])
                print(f"[serve] timeline: wrote {n} step records to {kit['timeline_export']}",
                      file=sys.stderr, flush=True)
            if kit["sink"] is not None:
                kit["sink"].close()

    def _serve_follow(self, ckpt: str, spec, device) -> list:
        """``serve --serve.mesh.*`` on a rank other than the driver: load the
        checkpoint, build the allocator with the driver and run this rank's
        group until the driver stops it. Prints nothing; returns []."""
        from perceiver_io_tpu_torch.models import model_for_config
        from perceiver_io_tpu_torch.serving.sharding import MeshGroupAllocator
        from perceiver_io_tpu_torch.training.checkpoint import load_pretrained

        state, model_cfg = load_pretrained(ckpt)
        model = model_for_config(model_cfg, device=device)
        model.load_state_dict(state, strict=True)
        model.eval()
        MeshGroupAllocator(spec, device=device).follow(model)
        return []

    def _serve_http(self, engine, tok, args, kit) -> list:
        """``serve --serve.http.port=N``: run the streaming gateway over the
        built engine or fleet until ``--serve.http.max_streams`` streams
        ended (or Ctrl-C), then drain and print the ``serve_stats`` line,
        the gateway's wire counters included. The gateway's thread is the
        engine's only driver meanwhile: this thread waits."""
        import json
        import time

        from perceiver_io_tpu_torch.observability import default_ledger, default_registry
        from perceiver_io_tpu_torch.serving.gateway import STREAM_MODES, StreamingGateway

        if args.http.stream not in STREAM_MODES:
            raise SystemExit(
                "--serve.http.stream must be one of "
                f"{'|'.join(STREAM_MODES)}, got {args.http.stream!r}"
            )
        t0 = time.monotonic()
        gateway = StreamingGateway(
            engine,
            host=args.http.host,
            port=args.http.port,
            stream=args.http.stream,
            encode=lambda text: tok.encode(text),
            decode=lambda ids: tok.decode(ids),
            registry=kit["registry"],
            tracer=engine.tracer if hasattr(engine, "tracer") else None,
            slo_monitor=kit["slo_monitor"],
            snapshot_writer=kit["snapshot_writer"],
            flight_recorder=kit["flight_recorder"],
            max_streams=args.http.max_streams,
        )
        gateway.run_in_thread()
        print(
            f"[serve] http gateway listening on {gateway.host}:{gateway.port} "
            f"(stream={args.http.stream}"
            + (f", max_streams={args.http.max_streams}"
               if args.http.max_streams is not None else "")
            + ")",
            file=sys.stderr, flush=True,
        )
        try:
            gateway.wait()
        except KeyboardInterrupt:
            print("[serve] interrupt: shutting the gateway down", file=sys.stderr, flush=True)
        finally:
            gateway.close()
        engine.drain()
        if kit["slo_monitor"] is not None:
            # the last drain step's dispositions (a fleet polls at the
            # start of a step)
            kit["slo_monitor"].poll()
        wall_s = time.monotonic() - t0
        if args.stats:
            stats = engine.stats()
            stats["health"] = engine.health()
            stats["wall_s"] = round(wall_s, 3)
            stats["gateway"] = gateway.stats()
            stats["metrics"] = engine.registry.snapshot()
            stats["compile_ledger"] = default_ledger().snapshot()
            stats["process_metrics"] = default_registry().snapshot()
            if kit["slo_monitor"] is not None and "slo" not in stats:
                stats["slo"] = kit["slo_monitor"].stats()
            if kit["flight_recorder"] is not None:
                stats["incident"] = kit["flight_recorder"].stats()
            if kit["timeline"] is not None and "timeline" not in stats:
                stats["timeline"] = kit["timeline"].summary()
            print(json.dumps({"serve_stats": stats}), flush=True)
        return []

    def _serve_prompts(self, engine, tok, prompts, args, kit) -> list:
        import json
        import time

        from perceiver_io_tpu_torch.observability import default_ledger, default_registry
        from perceiver_io_tpu_torch.reliability import QueueFull

        t0 = time.monotonic()
        pad_id = tok.pad_token_id or 0
        writer, recorder, slo_monitor = (kit["snapshot_writer"], kit["flight_recorder"],
                                         kit["slo_monitor"])

        def step() -> None:
            # a fleet whose every breaker is open makes no progress until a
            # cooldown elapses: yield instead of spinning (an engine always
            # progresses while pending)
            if engine.step() == 0 and not getattr(engine, "last_step_made_progress", True):
                time.sleep(0.005)

        # (prompt, ServeRequest | None, error | None, trace_id | None, status)
        handles: list = []
        for p in prompts:
            ids = np.asarray(tok.encode(p), np.int32)
            try:
                # backpressure: make room BEFORE submitting so a full queue
                # drains work instead of tripping the shed counter
                while not engine.health()["ready"] and engine.pending():
                    step()
                req = engine.submit(ids)
                handles.append((p, req, None, req.trace_id, None))
            except (ValueError, QueueFull) as e:
                # reject/shed this line, keep serving the rest; the engine
                # already wrote its terminal span, whose trace id it carries
                handles.append(
                    (p, None, f"{type(e).__name__}: {e}", getattr(e, "trace_id", None),
                     "shed" if isinstance(e, QueueFull) else "rejected")
                )
            if writer is not None:
                writer.maybe_write()
            if recorder is not None:
                recorder.maybe_record()
        # drive off pending(), not step()'s return value: a slot-engine step
        # advances one token and legitimately disposes of nothing; the
        # snapshot cadence, the SLO polls and the recorder's ring keep up (a
        # fleet polls its own monitor inside step())
        fleet_polls = hasattr(engine, "slo_monitor")
        while engine.pending():
            step()
            if slo_monitor is not None and not fleet_polls:
                slo_monitor.poll()
            if writer is not None:
                writer.maybe_write()
            if recorder is not None:
                recorder.maybe_record()
        if slo_monitor is not None:
            # the last step's dispositions (a fleet polls at the start of a
            # step); a second poll is an idempotent counter diff
            slo_monitor.poll()
        engine.drain()  # queue already empty: just stop accepting
        wall_s = time.monotonic() - t0

        results = []
        for p, req, error, trace_id, status in handles:
            if req is not None and req.status == "ok":
                completion = tok.decode([t for t in req.result.tolist() if t != pad_id])
                results.append({
                    "prompt": p, "completion": completion,
                    "status": "ok", "trace_id": trace_id,
                })
            else:
                results.append({
                    "prompt": p,
                    "error": error if req is None else (req.error or req.status),
                    "status": status if req is None else req.status,
                    "trace_id": trace_id,
                })
        for row in results:
            print(json.dumps(row), flush=True)
        if args.stats:
            stats = engine.stats()
            stats["health"] = engine.health()
            stats["wall_s"] = round(wall_s, 3)
            stats["metrics"] = engine.registry.snapshot()
            # the full build table and the process-wide registry (the
            # ledger's families, the device and KV gauges)
            stats["compile_ledger"] = default_ledger().snapshot()
            stats["process_metrics"] = default_registry().snapshot()
            if slo_monitor is not None and "slo" not in stats:
                stats["slo"] = slo_monitor.stats()  # a fleet's stats() embeds it
            if recorder is not None:
                stats["incident"] = recorder.stats()
            if kit["timeline"] is not None and "timeline" not in stats:
                stats["timeline"] = kit["timeline"].summary()
            print(json.dumps({"serve_stats": stats}), flush=True)
        return results

    def _print_help(self) -> None:
        print(f"usage: {self.family.name} {{fit|validate|test|preproc|serve|obs}} [--flag=value ...]")
        print("flag groups: --model.* --data.* --trainer.* --optimizer.* "
              "--lr_scheduler.* --config=<yaml> --data=<name> --ckpt=<dir> "
              "--params=<dir> --device={cuda|cpu}")
        print("serve: --ckpt=<dir> --serve.prompts=<file|stdin> --serve.max_new_tokens "
              "--serve.num_latents --serve.engine={bucket|slots} --serve.slots "
              "--serve.prefill_chunk --serve.decode_strategy={auto|cached|recompute} "
              "--serve.decode_strategy_file "
              "--serve.kv_layout={auto|dense|paged|paged_int8} --serve.kv_block_size "
              "--serve.kv_blocks --serve.prefix_cache={auto|on|off} "
              "--serve.speculation={auto|off|k<K>d<D>} "
              "--serve.preemption={recompute|swap|auto} --serve.admit_headroom_blocks "
              "--serve.swap_gbps --serve.prompt_buckets --serve.batch_buckets "
              "--serve.warmup --serve.seed --serve.max_queue --serve.deadline_s "
              "--serve.replicas=<n> --serve.failover={true|false} "
              "--serve.step_timeout_s=<s>")
        print("serve autoscale: --serve.autoscale.max=<n> --serve.autoscale.min "
              "--serve.autoscale.up_cooldown_s --serve.autoscale.down_cooldown_s "
              "--serve.autoscale.up_evidence --serve.autoscale.down_evidence "
              "--serve.autoscale.queue_high --serve.autoscale.queue_low "
              "--serve.autoscale.scale_up_slots — SLO-driven fleet elasticity: "
              "burn/queue pressure scales replicas up to max, cooldown-gated "
              "zero-downtime scale-down")
        print("serve http gateway: --serve.http.port=<n|0> --serve.http.host "
              "--serve.http.stream={sse|jsonl} --serve.http.max_streams — "
              "POST /v1/generate streams tokens as they decode; GET /healthz, "
              "GET /metrics; client disconnects cancel mid-generation")
        print("observability: --obs.events_path=<events.jsonl> --obs.snapshot_every_s "
              "--obs.snapshot_path --obs.profile_on_regress_factor "
              "--obs.trace_sample=<0..1> --obs.trace_keep_slow_ms "
              "--obs.events_max_bytes (fit and serve; docs/observability.md)")
        print("incident flight recorder: --obs.incident.dir=<dir> "
              "--obs.incident.cooldown_s --obs.incident.max_bundles "
              "--obs.incident.keep_spans — triggered bounded bundles at the "
              "serving seams (SLO breach, replica failure, pool exhaustion, "
              "preemption storm, autoscaler escalation, gateway mass-disconnect); "
              "analyze with obs incident --bundle=<dir>")
        print("slo (serve): --obs.slo.ttft_p95_ms --obs.slo.inter_token_p95_ms "
              "--obs.slo.error_rate --obs.slo.fast_window_s --obs.slo.slow_window_s "
              "--obs.slo.burn_rate --obs.slo.shed_factor — burn-rate monitor, "
              "breach events, fleet admission tightening")
        print("timeline (serve): --obs.timeline.steps=<n> --obs.timeline.export"
              "=<timeline.jsonl> --obs.timeline.swap_gbps — per-pass scheduler "
              "ring (admissions, slot occupancy, preemption post-mortems); "
              "analyze with obs timeline")
        print("obs report: --events=<events.jsonl> [--snapshot=<snapshot.json>] "
              "[--top N] [--json true] — offline latency/compile/padding report")
        print("obs incident: --bundle=<incident dir> [--top N] [--json true]")
        print("obs timeline: --timeline=<timeline.jsonl> [--events=<events.jsonl>] "
              "[--snapshot=<snapshot.json>] [--trace_out=<trace.json>] — "
              "per-slot gantt + per-request decomposition + Chrome-trace export")
        print("mesh (fit/validate/test): --mesh.data --mesh.fsdp --mesh.model --mesh.seq — "
              "one process per rank under torchrun (--device=cuda: cuda:LOCAL_RANK over NCCL; "
              "--device=cpu: gloo); --trainer.shard_seq shards the batches' sequence over seq")
        print("serve mesh: --serve.mesh.data --serve.mesh.model --serve.mesh.device_offset — "
              "the sharded slot engine under torchrun (one rank per device; rank 0 serves, "
              "the others follow), one disjoint rank group a replica")
        print(f"data modules: {sorted(self.family.data_registry)}")


def _ctor_flag_specs(cls, prefix: str) -> Dict[str, Any]:
    """Flag specs from ``__init__`` signatures (datamodules are plain
    classes, not dataclasses). Walks the MRO while ``**kwargs`` forwards to
    the base class, so subclass flags include inherited knobs."""
    import inspect

    specs: Dict[str, Any] = {}
    for klass in cls.__mro__:
        if klass is object or "__init__" not in vars(klass):
            continue
        sig = inspect.signature(klass.__init__)
        hints = typing.get_type_hints(klass.__init__)
        has_var_kw = False
        for name, param in sig.parameters.items():
            if param.kind is inspect.Parameter.VAR_KEYWORD:
                has_var_kw = True
                continue
            if name == "self" or param.kind is inspect.Parameter.VAR_POSITIONAL:
                continue
            specs.setdefault(f"{prefix}.{name}", hints.get(name, str))
        if not has_var_kw:
            break
    return specs
