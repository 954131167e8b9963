"""Measured decode strategies: the registry of verdicts and the autotuners.

Counterpart of ``perceiver_io_tpu/inference/decode_strategy.py``. Four axes
of the decode path are platform and shape questions, so each is a measured
choice kept in one process registry:

- the boundary phase's step, ``cached`` or ``recompute``
  (:class:`DecodeStrategy`, :func:`resolve`, :func:`autotune_boundary`);
- the slot engine's KV layout, ``dense``, ``paged`` or ``paged_int8``
  (:func:`resolve_kv_layout`, :func:`autotune_kv_layout`, whose int8 arm is
  quality-gated by :func:`quant_quality_probe`);
- the slot engine's prefix cache, ``on`` or ``off``
  (:func:`resolve_prefix_cache`; a deployment records it);
- the slot engine's self-draft speculation, ``off`` or ``k{K}d{D}``
  (:func:`resolve_speculation`, :func:`autotune_speculation`).

Every resolver takes the order explicit argument > environment variable >
registry verdict > the status-quo default. The swap-rate registry keeps
the host link's measured rate per platform for the slot engine's swap cost
model (:func:`record_swap_gbps`, :func:`lookup_swap_gbps`).
:func:`save_registry` writes every verdict to one JSON file (schema
``version: 1``, JAX's), :func:`load_registry` merges one in, and
``PERCEIVER_DECODE_STRATEGY_FILE`` names a file every lookup merges first.

Registry keys are ``(shape_key, platform, env)``, where ``platform`` is the
torch device type (``"cuda"`` or ``"cpu"``) and ``env`` the port's
fingerprint of its environment switches, ``(PERCEIVER_FUSED_QKV,
PERCEIVER_FLASH_MIN_KV)`` normalised
(:func:`~perceiver_io_tpu_torch.models.core.modules.trace_env_fingerprint`),
so a verdict measured under one setting is not served under another. A file
whose keys end in ``()`` (written before the port read either switch, so
with both at their defaults) loads under ``(False, 0)``; a file written by
the JAX package loads its entries under JAX's own keys, which the port
never looks up.

Each probe reads the clock only after a host read of its last token (a
fence on the card), so a probe times the device's work, not its dispatch.

``python -m perceiver_io_tpu_torch.inference.decode_strategy`` runs the
three autotuners on a small CLM (on the card unless ``--device cpu``) and
prints the verdicts as one JSON line.
"""
from __future__ import annotations

import ast
import dataclasses
import json
import os
import time
from typing import Callable, Optional, Union

import numpy as np
import torch

from perceiver_io_tpu_torch.models.core.modules import trace_env_fingerprint

MODES = ("auto", "cached", "recompute")
PHASE_CHOICES = ("cached", "recompute")

KV_LAYOUTS = ("auto", "dense", "paged", "paged_int8")
KV_LAYOUT_CHOICES = ("dense", "paged", "paged_int8")
#: the layouts that address KV through the block pool
PAGED_KV_LAYOUTS = ("paged", "paged_int8")

PREFIX_CACHE_MODES = ("auto", "on", "off")
PREFIX_CACHE_CHOICES = ("on", "off")

#: ``k{K}d{D}`` drafts K tokens a round from the first D stack layers; the
#: measured grid stops at D = 2, past which a draft costs near a full step
SPECULATION_CHOICES = ("off",) + tuple(f"k{k}d{d}" for d in (1, 2) for k in (2, 4, 8))
SPECULATION_MODES = ("auto",) + SPECULATION_CHOICES

#: env var overriding the boundary-phase strategy process-wide
ENV_VAR = "PERCEIVER_DECODE_STRATEGY"
#: env var overriding the slot engine's KV layout process-wide
ENV_KV_LAYOUT = "PERCEIVER_KV_LAYOUT"
#: env var overriding the slot engine's prefix-cache mode process-wide
ENV_PREFIX_CACHE = "PERCEIVER_PREFIX_CACHE"
#: env var overriding the slot engine's speculation mode process-wide
ENV_SPECULATION = "PERCEIVER_SPECULATION"
#: env var naming a registry JSON file every lookup merges first
ENV_FILE = "PERCEIVER_DECODE_STRATEGY_FILE"
#: env var overriding the int8 quality gate's budget
ENV_KV_QUANT_BUDGET = "PERCEIVER_KV_QUANT_BUDGET"
#: the int8 quality gate's default budget: the largest |logit delta| against
#: the exact paged layout over every greedy step of the probe workload
DEFAULT_KV_QUANT_BUDGET = 0.05
#: acceptance below which the speculation autotuner declines whatever the
#: timing: a k-token round emits ~1 + a*k tokens at acceptance a
DEFAULT_SPEC_ACCEPT_FLOOR = 0.5


def kv_quant_budget() -> float:
    """The int8 quality gate's budget (:data:`ENV_KV_QUANT_BUDGET` >
    :data:`DEFAULT_KV_QUANT_BUDGET`; an unparseable override falls back to
    the default)."""
    raw = os.environ.get(ENV_KV_QUANT_BUDGET)
    if raw:
        try:
            return float(raw)
        except ValueError:
            pass
    return DEFAULT_KV_QUANT_BUDGET


@dataclasses.dataclass(frozen=True)
class DecodeStrategy:
    """Per-phase cache strategy. ``window`` is pinned to recompute (the
    learned absolute position embedding re-positions every token each
    step); ``latent == "recompute"`` forces the boundary to recompute too,
    since the boundary cache is built by the latent steps."""

    latent: str = "cached"
    boundary: str = "cached"
    window: str = "recompute"

    def __post_init__(self):
        for phase in ("latent", "boundary"):
            value = getattr(self, phase)
            if value not in PHASE_CHOICES:
                raise ValueError(f"{phase} strategy must be one of {PHASE_CHOICES}, got {value!r}")
        if self.window != "recompute":
            raise ValueError(
                "window strategy is pinned to 'recompute': the learned absolute position "
                "embedding re-positions every surviving token each step, so no exact "
                "incremental form exists"
            )

    @property
    def boundary_cached(self) -> bool:
        return self.latent == "cached" and self.boundary == "cached"


#: (shape_key, platform, ()) -> entry, one dict per axis, so that artifacts
#: of different axes merge without clobbering each other
_REGISTRY: dict = {}
_KV_REGISTRY: dict = {}
_PREFIX_REGISTRY: dict = {}
_SPEC_REGISTRY: dict = {}
#: platform -> {"swap_gbps": float, ...}: the host link is hardware, so its
#: rate is keyed by the platform alone
_SWAP_REGISTRY: dict = {}
_FILE_LOADED: set = set()  # paths already merged


def shape_key(model) -> tuple:
    """The architecture coordinates the verdicts depend on: window, latent
    count, width, heads and stack depth (batch is left out: both sides of
    every trade scale with it)."""
    cfg = model.config
    return (int(cfg.max_seq_len), int(cfg.max_latents), int(cfg.num_channels),
            int(cfg.num_heads), int(cfg.num_self_attention_layers))


def _platform(platform: Optional[str]) -> str:
    """The platform a lookup without a model reads: the card when there is
    one (JAX's ``default_backend()``)."""
    if platform is not None:
        return str(platform)
    return "cuda" if torch.cuda.is_available() else "cpu"


def registry_key(model, platform: Optional[str] = None) -> tuple:
    """``(shape_key, platform, env fingerprint)``; ``platform`` defaults to
    the device type the model lies on."""
    return (shape_key(model), str(platform or model.device.type), trace_env_fingerprint())


def _maybe_load_env_file() -> None:
    path = os.environ.get(ENV_FILE)
    if path and path not in _FILE_LOADED and os.path.exists(path):
        load_registry(path)


def _lookup(registry: dict, field: str, model, platform: Optional[str]) -> Optional[str]:
    _maybe_load_env_file()
    entry = registry.get(registry_key(model, platform))
    return None if entry is None else entry[field]


def _entry(registry: dict, model, platform: Optional[str]) -> Optional[dict]:
    _maybe_load_env_file()
    entry = registry.get(registry_key(model, platform))
    return None if entry is None else dict(entry)


def _record(registry: dict, field: str, choices: tuple, model, value: str,
            platform: Optional[str], extra: dict) -> dict:
    if value not in choices:
        raise ValueError(f"{field} must be one of {choices}, got {value!r}")
    entry = {field: value, **extra}
    registry[registry_key(model, platform)] = entry
    return entry


def lookup(model, platform: Optional[str] = None) -> Optional[str]:
    """Measured boundary winner for this shape and platform, or None."""
    return _lookup(_REGISTRY, "boundary", model, platform)


def record(model, boundary: str, *, platform: Optional[str] = None, **extra) -> dict:
    """Store a boundary verdict (and its measurements); returns the entry."""
    return _record(_REGISTRY, "boundary", PHASE_CHOICES, model, boundary, platform, extra)


def lookup_kv_layout(model, platform: Optional[str] = None) -> Optional[str]:
    """Measured KV-layout winner for this shape and platform, or None."""
    return _lookup(_KV_REGISTRY, "kv_layout", model, platform)


def kv_entry(model, platform: Optional[str] = None) -> Optional[dict]:
    """The whole KV-layout entry (verdict, timings and the ``quant_gate``
    outcome), or None."""
    return _entry(_KV_REGISTRY, model, platform)


def record_kv_layout(model, kv_layout: str, *, platform: Optional[str] = None, **extra) -> dict:
    """Store a KV-layout verdict; returns the entry."""
    return _record(_KV_REGISTRY, "kv_layout", KV_LAYOUT_CHOICES, model, kv_layout, platform, extra)


def lookup_prefix_cache(model, platform: Optional[str] = None) -> Optional[str]:
    """Recorded prefix-cache verdict for this shape and platform, or None."""
    return _lookup(_PREFIX_REGISTRY, "prefix_cache", model, platform)


def record_prefix_cache(model, prefix_cache: str, *, platform: Optional[str] = None,
                        **extra) -> dict:
    """Store a prefix-cache verdict (with, e.g., the hit ratio a deployment
    observed); returns the entry."""
    return _record(_PREFIX_REGISTRY, "prefix_cache", PREFIX_CACHE_CHOICES, model, prefix_cache,
                   platform, extra)


def lookup_speculation(model, platform: Optional[str] = None) -> Optional[str]:
    """Measured speculation winner for this shape and platform, or None."""
    return _lookup(_SPEC_REGISTRY, "speculation", model, platform)


def spec_entry(model, platform: Optional[str] = None) -> Optional[dict]:
    """The whole speculation entry (verdict, timings, acceptance), or None."""
    return _entry(_SPEC_REGISTRY, model, platform)


def record_speculation(model, speculation: str, *, platform: Optional[str] = None,
                       **extra) -> dict:
    """Store a speculation verdict; returns the entry."""
    return _record(_SPEC_REGISTRY, "speculation", SPECULATION_CHOICES, model, speculation,
                   platform, extra)


def lookup_swap_gbps(platform: Optional[str] = None) -> Optional[float]:
    """Calibrated host-link rate (decimal GB/s) for this platform, or None
    when no swap was measured here."""
    _maybe_load_env_file()
    entry = _SWAP_REGISTRY.get(_platform(platform))
    return None if entry is None else float(entry["swap_gbps"])


def swap_entry(platform: Optional[str] = None) -> Optional[dict]:
    """The whole swap-rate entry (rate and the last transfer), or None."""
    _maybe_load_env_file()
    entry = _SWAP_REGISTRY.get(_platform(platform))
    return None if entry is None else dict(entry)


def record_swap_gbps(gbps: float, *, platform: Optional[str] = None, **extra) -> dict:
    """Store a measured host-link rate for this platform; returns the entry.
    The slot engine records one after every real swap transfer."""
    gbps = float(gbps)
    if not gbps > 0:
        raise ValueError(f"swap_gbps must be > 0, got {gbps!r}")
    entry = {"swap_gbps": gbps, **extra}
    _SWAP_REGISTRY[_platform(platform)] = entry
    return entry


def reset_registry() -> None:
    """Drop every verdict and forget the files merged (test isolation)."""
    for registry in (_REGISTRY, _KV_REGISTRY, _PREFIX_REGISTRY, _SPEC_REGISTRY, _SWAP_REGISTRY,
                     _FILE_LOADED):
        registry.clear()


def _key_to_json(key: tuple) -> dict:
    shape, platform, env = key
    return {"shape": list(shape), "platform": platform, "env": repr(env)}


#: the fingerprint of a key written before the port read its switches
_DEFAULT_ENV = (False, 0)


def _key_from_json(obj: dict) -> tuple:
    env = ast.literal_eval(obj["env"])
    return (tuple(obj["shape"]), obj["platform"], _DEFAULT_ENV if env == () else env)


#: (file field, registry, verdict field, choices) of the shape-keyed axes
_AXES = (
    ("entries", _REGISTRY, "boundary", PHASE_CHOICES),
    ("kv_entries", _KV_REGISTRY, "kv_layout", KV_LAYOUT_CHOICES),
    ("prefix_entries", _PREFIX_REGISTRY, "prefix_cache", PREFIX_CACHE_CHOICES),
    ("spec_entries", _SPEC_REGISTRY, "speculation", SPECULATION_CHOICES),
)


def save_registry(path: str) -> None:
    """Write every verdict to ``path`` as JSON, atomically (a temporary file
    renamed into place)."""
    data = {"version": 1}
    for field, registry, _, _ in _AXES:
        data[field] = [{"key": _key_to_json(key), **entry}
                       for key, entry in sorted(registry.items(), key=lambda kv: repr(kv[0]))]
    data["swap_entries"] = [{"platform": platform, **entry}
                            for platform, entry in sorted(_SWAP_REGISTRY.items())]
    dirpath = os.path.dirname(path)
    if dirpath:
        os.makedirs(dirpath, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(data, fh, indent=2)
    os.replace(tmp, path)


def load_registry(path: str) -> int:
    """Merge a registry file into the process registry; returns the entries
    loaded. An unreadable or malformed file loads 0 (a corrupt cache means
    measuring again, not failing to serve)."""
    _FILE_LOADED.add(path)
    try:
        with open(path) as fh:
            data = json.load(fh)
    except (OSError, ValueError):
        return 0
    if not isinstance(data, dict):
        return 0
    loaded = 0
    for field, registry, value_key, choices in _AXES:
        items = data.get(field)
        if not isinstance(items, list):
            continue
        for item in items:
            if not isinstance(item, dict):
                continue
            try:
                key = _key_from_json(item["key"])
                entry = {k: v for k, v in item.items() if k != "key"}
                if entry.get(value_key) not in choices:
                    continue
            except (KeyError, ValueError, SyntaxError, TypeError):
                continue
            registry[key] = entry
            loaded += 1
    swap_items = data.get("swap_entries")
    if isinstance(swap_items, list):
        for item in swap_items:
            if not isinstance(item, dict):
                continue
            platform, gbps = item.get("platform"), item.get("swap_gbps")
            if not isinstance(platform, str) or not isinstance(gbps, (int, float)) or not gbps > 0:
                continue
            _SWAP_REGISTRY[platform] = {k: v for k, v in item.items() if k != "platform"}
            loaded += 1
    return loaded


def _mode(mode: Optional[str], env: str, modes: tuple, what: str) -> str:
    """An explicit mode, else the env var, else ``"auto"``; validated."""
    if mode is None:
        mode = os.environ.get(env) or "auto"
    if mode not in modes:
        raise ValueError(f"{what} must be one of {modes}, got {mode!r}")
    return mode


def resolve(mode: Union[None, str, DecodeStrategy], model=None, *,
            platform: Optional[str] = None) -> DecodeStrategy:
    """A strategy request as a :class:`DecodeStrategy`: an explicit one wins,
    then an explicit mode, then :data:`ENV_VAR`, then ``"auto"``, which reads
    the registry verdict and falls back to the cached default."""
    if isinstance(mode, DecodeStrategy):
        return mode
    if mode is None:
        mode = os.environ.get(ENV_VAR) or "auto"
    if mode not in MODES:
        raise ValueError(
            f"decode strategy must be one of {MODES} (or a DecodeStrategy), got {mode!r}"
        )
    if mode == "auto":
        measured = lookup(model, platform) if model is not None else None
        return DecodeStrategy(boundary=measured or "cached")
    return DecodeStrategy(boundary=mode)


def resolve_kv_layout(mode: Optional[str], model=None, *, platform: Optional[str] = None) -> str:
    """A KV-layout request as one of :data:`KV_LAYOUT_CHOICES`: explicit >
    :data:`ENV_KV_LAYOUT` > registry > ``"dense"``."""
    mode = _mode(mode, ENV_KV_LAYOUT, KV_LAYOUTS, "kv layout")
    if mode == "auto":
        return (lookup_kv_layout(model, platform) if model is not None else None) or "dense"
    return mode


def resolve_prefix_cache(mode: Optional[str], model=None, *,
                         platform: Optional[str] = None) -> str:
    """A prefix-cache request as ``"on"`` or ``"off"``: explicit >
    :data:`ENV_PREFIX_CACHE` > registry > ``"off"``. The engine enforces the
    pairing with a paged layout."""
    mode = _mode(mode, ENV_PREFIX_CACHE, PREFIX_CACHE_MODES, "prefix cache")
    if mode == "auto":
        return (lookup_prefix_cache(model, platform) if model is not None else None) or "off"
    return mode


def resolve_speculation(mode: Optional[str], model=None, *,
                        platform: Optional[str] = None) -> str:
    """A speculation request as one of :data:`SPECULATION_CHOICES`: explicit >
    :data:`ENV_SPECULATION` > registry > ``"off"``. The engine enforces
    greedy decoding."""
    mode = _mode(mode, ENV_SPECULATION, SPECULATION_MODES, "speculation")
    if mode == "auto":
        return (lookup_speculation(model, platform) if model is not None else None) or "off"
    return mode


# -- the autotuners ----------------------------------------------------------
def _fence(model) -> None:
    """Wait for the card's queued work before a clock read (the probes' own
    host reads fence too; this covers what follows them)."""
    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)


def _short_circuit(registry: dict, field: str, model, persist: Optional[str],
                   force: bool) -> Optional[str]:
    """Merge ``persist`` and the env file; the stored verdict unless ``force``."""
    if persist:
        load_registry(persist)
    _maybe_load_env_file()
    entry = registry.get(registry_key(model))
    return None if force or entry is None else entry[field]


def autotune_boundary(model, *, batch: int = 1, new_tokens: int = 4,
                      clock: Callable[[], float] = time.perf_counter,
                      persist: Optional[str] = None, force: bool = False) -> str:
    """Measure cached against recompute boundary-phase decoding at the
    model's shape and record the winner; returns ``"cached"`` or
    ``"recompute"``.

    Every generated token sits in the boundary phase (latents start maxed,
    the prompt fills the window but ``new_tokens``). Each mode runs once
    untimed and once timed on ``clock``; ties (a frozen clock's zeros)
    break toward ``cached``. A shape whose window equals its latent count
    has no boundary phase and records ``cached`` unmeasured.

    :param persist: a registry file merged before deciding (its verdict
        short-circuits the measurement unless ``force``) and written after.
    """
    from perceiver_io_tpu_torch.inference.generate import GenerationConfig, generate

    stored = _short_circuit(_REGISTRY, "boundary", model, persist, force)
    if stored is not None:
        return stored
    n, max_latents = model.max_seq_len, model.max_latents
    boundary_room = n - max_latents
    if boundary_room < 1:
        record(model, "cached", note="no boundary phase at this shape")
        if persist:
            save_registry(persist)
        return "cached"
    new_tokens = max(1, min(new_tokens, boundary_room))
    prompt_len = n - new_tokens
    rng = np.random.default_rng(0)
    prompt = rng.integers(1, model.config.vocab_size, size=(batch, prompt_len), dtype=np.int32)
    gcfg = GenerationConfig(max_new_tokens=new_tokens, num_latents=max_latents)

    timings = {}
    for mode in PHASE_CHOICES:
        ids = generate(model, prompt, gcfg, decode_strategy=mode, device=model.device)
        int(ids[0, -1])  # warm + fence
        _fence(model)
        t0 = clock()
        ids = generate(model, prompt, gcfg, decode_strategy=mode, device=model.device)
        int(ids[0, -1])  # host read: the fence
        _fence(model)
        timings[mode] = (clock() - t0) / new_tokens * 1e3
    winner = "cached" if timings["cached"] <= timings["recompute"] else "recompute"
    record(model, winner, cached_ms_per_token=round(timings["cached"], 4),
           recompute_ms_per_token=round(timings["recompute"], 4), batch=batch,
           new_tokens=new_tokens)
    if persist:
        save_registry(persist)
    return winner


def _kv_probe_workload(model, slots: int, new_tokens: int):
    """The shared probe geometry of the KV and speculation autotuners:
    mid-context prompts (the paged gather's cost scales with the context)
    and an EOS-free greedy config, so every arm runs the same schedule.

    :return: ``(table, config, prompts, new_tokens)``.
    """
    from perceiver_io_tpu_torch.inference.generate import GenerationConfig
    from perceiver_io_tpu_torch.serving.buckets import BucketTable

    n = model.max_seq_len
    num_latents = min(2, model.max_latents)
    prompt_len = max(num_latents, min(n // 2, model.max_prefix_len + num_latents))
    new_tokens = max(1, min(new_tokens, n - prompt_len))
    table = BucketTable(prompt_lens=(prompt_len,), batch_sizes=(1,))
    gcfg = GenerationConfig(max_new_tokens=new_tokens, num_latents=num_latents)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, model.config.vocab_size, size=prompt_len, dtype=np.int32)
               for _ in range(slots)]
    return table, gcfg, prompts, new_tokens


def _timed_pass(make, prompts, clock, model) -> tuple:
    """One untimed pass of a fresh engine, then a timed pass of another;
    returns ``(seconds, timed engine)``."""
    make().serve(prompts)
    engine = make()
    for p in prompts:
        engine.submit(p)
    _fence(model)
    t0 = clock()
    engine.run_until_idle()  # each step ends in a host read of its tokens
    _fence(model)
    return clock() - t0, engine


def quant_quality_probe(model, *, slots: int = 2, block_size: int = 16, new_tokens: int = 8,
                        budget: Optional[float] = None) -> dict:
    """The int8 layout's greedy fidelity against the exact paged layout: one
    engine of each in lockstep over the probe workload, comparing the logits
    of slots live in both after every step. Returns
    ``{"max_logit_delta", "token_match_rate", "budget", "passed"}``;
    ``passed`` is ``max_logit_delta <= budget``."""
    from perceiver_io_tpu_torch.serving.slots import SlotServingEngine

    budget = kv_quant_budget() if budget is None else float(budget)
    table, gcfg, prompts, _ = _kv_probe_workload(model, slots, new_tokens)
    engines, reqs = {}, {}
    for layout in PAGED_KV_LAYOUTS:
        eng = SlotServingEngine(model, gcfg, table, slots=slots, kv_layout=layout,
                                kv_block_size=block_size, device=model.device)
        engines[layout] = eng
        reqs[layout] = [eng.submit(p) for p in prompts]
    exact, quant = engines["paged"], engines["paged_int8"]
    max_delta = 0.0
    while exact.pending() or quant.pending():
        if exact.pending():
            exact.step()
        if quant.pending():
            quant.step()
        live = [i for i, (se, sq) in enumerate(zip(exact._slots, quant._slots))
                if se is not None and sq is not None]
        if live:
            le = exact._state["logits"][live].float()
            lq = quant._state["logits"][live].float()
            max_delta = max(max_delta, float((le - lq).abs().max()))
    matched = total = 0
    for r_exact, r_quant in zip(reqs["paged"], reqs["paged_int8"]):
        te, tq = list(r_exact.result), list(r_quant.result)
        total += max(len(te), len(tq))
        matched += sum(1 for a, b in zip(te, tq) if a == b)
    return {"max_logit_delta": round(max_delta, 6),
            "token_match_rate": round(matched / max(total, 1), 4),
            "budget": budget, "passed": bool(max_delta <= budget)}


def autotune_kv_layout(model, *, slots: int = 2, block_size: int = 16, new_tokens: int = 8,
                       clock: Callable[[], float] = time.perf_counter,
                       persist: Optional[str] = None, force: bool = False) -> str:
    """Measure dense, paged and int8-paged slot decoding at the model's
    shape and record the winner; returns one of :data:`KV_LAYOUT_CHOICES`.

    Each layout drives a small slot engine over the probe workload: one
    pass untimed, one timed on ``clock``. Ties break toward ``dense``, then
    exact ``paged`` over ``paged_int8``; int8 wins only if
    :func:`quant_quality_probe` passes (its outcome is recorded either way,
    as ``quant_gate``). Time at equal capacity is what is measured; an
    operator who sizes the pool below dense has chosen paged already.

    :param persist: as :func:`autotune_boundary`'s.
    """
    from perceiver_io_tpu_torch.serving.slots import SlotServingEngine

    stored = _short_circuit(_KV_REGISTRY, "kv_layout", model, persist, force)
    if stored is not None:
        return stored
    table, gcfg, prompts, new_tokens = _kv_probe_workload(model, slots, new_tokens)
    timings = {}
    for layout in KV_LAYOUT_CHOICES:
        # sizing the pool is choosing a paged layout, so only those arms size it
        kv_kwargs = {"kv_block_size": block_size} if layout in PAGED_KV_LAYOUTS else {}

        def make():
            return SlotServingEngine(model, gcfg, table, slots=slots, kv_layout=layout,
                                     device=model.device, **kv_kwargs)

        seconds, _ = _timed_pass(make, prompts, clock, model)
        timings[layout] = seconds / (slots * new_tokens) * 1e3
    quality = quant_quality_probe(model, slots=slots, block_size=block_size,
                                  new_tokens=new_tokens)
    winner = "dense" if timings["dense"] <= timings["paged"] else "paged"
    if winner == "paged" and quality["passed"] and timings["paged_int8"] < timings["paged"]:
        winner = "paged_int8"
    record_kv_layout(
        model, winner, dense_ms_per_token=round(timings["dense"], 4),
        paged_ms_per_token=round(timings["paged"], 4),
        paged_int8_ms_per_token=round(timings["paged_int8"], 4), quant_gate=quality,
        slots=slots, block_size=block_size, new_tokens=new_tokens,
    )
    if persist:
        save_registry(persist)
    return winner


def autotune_speculation(model, *, slots: int = 2, new_tokens: int = 8,
                         candidates: tuple = ("k4d1",),
                         accept_floor: float = DEFAULT_SPEC_ACCEPT_FLOOR,
                         clock: Callable[[], float] = time.perf_counter,
                         persist: Optional[str] = None, force: bool = False) -> str:
    """Measure self-draft speculation against the plain one-token step at
    the model's shape and record the winner; returns one of
    :data:`SPECULATION_CHOICES`.

    Each arm drives a small slot engine over the probe workload (speculation
    emits the same tokens, so every arm runs the same schedule): one pass
    untimed, one timed on ``clock``. A draft wins only if its measured
    acceptance reaches ``accept_floor`` and its time per token beats
    ``"off"`` strictly; ties break toward ``"off"``. A candidate whose draft
    is as deep as the model's stack is skipped.

    :param persist: as :func:`autotune_boundary`'s.
    """
    from perceiver_io_tpu_torch.serving.slots import SlotServingEngine

    stored = _short_circuit(_SPEC_REGISTRY, "speculation", model, persist, force)
    if stored is not None:
        return stored
    num_layers = int(model.config.num_self_attention_layers)
    arms, skipped = ["off"], []
    for cand in candidates:
        if cand not in SPECULATION_CHOICES or cand == "off":
            raise ValueError(f"candidates must come from {SPECULATION_CHOICES[1:]}, got {cand!r}")
        (arms if int(cand.split("d")[1]) < num_layers else skipped).append(cand)

    table, gcfg, prompts, new_tokens = _kv_probe_workload(model, slots, new_tokens)
    timings, acceptance = {}, {}
    for arm in arms:
        def make():
            return SlotServingEngine(model, gcfg, table, slots=slots, speculation=arm,
                                     device=model.device)

        seconds, engine = _timed_pass(make, prompts, clock, model)
        timings[arm] = seconds / (slots * new_tokens) * 1e3
        if arm != "off":
            acceptance[arm] = engine.stats()["speculation"]["acceptance_rate"]
    winner = "off"
    for arm in arms[1:]:
        if acceptance[arm] < accept_floor or timings[arm] >= timings[winner]:
            continue
        winner = arm
    record_speculation(
        model, winner, timings_ms_per_token={a: round(t, 4) for a, t in timings.items()},
        acceptance={a: round(r, 4) for a, r in acceptance.items()}, accept_floor=accept_floor,
        skipped=skipped, slots=slots, new_tokens=new_tokens,
    )
    if persist:
        save_registry(persist)
    return winner


def main(argv=None) -> dict:
    """Run the boundary, KV-layout and speculation autotuners on a CLM of
    the given shape (random weights from seed 0) and print the verdicts and
    their measurements as one JSON line."""
    import argparse

    from perceiver_io_tpu_torch.models.text.clm import (
        CausalLanguageModel,
        CausalLanguageModelConfig,
    )

    p = argparse.ArgumentParser(description=main.__doc__)
    p.add_argument("--ctx", type=int, default=512)
    p.add_argument("--num-latents", type=int, default=64)
    p.add_argument("--num-channels", type=int, default=64)
    p.add_argument("--num-layers", type=int, default=2)
    p.add_argument("--num-heads", type=int, default=8)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--new-tokens", type=int, default=4)
    p.add_argument("--out", default=None, help="write the registry JSON file here")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)

    cfg = CausalLanguageModelConfig(
        vocab_size=262, max_seq_len=args.ctx, max_latents=args.num_latents,
        num_channels=args.num_channels, num_heads=args.num_heads,
        num_self_attention_layers=args.num_layers,
    )
    model = CausalLanguageModel(cfg, device=args.device).eval()
    with torch.no_grad():
        verdicts = {
            "boundary": autotune_boundary(model, batch=args.batch, new_tokens=args.new_tokens,
                                          force=True),
            "kv_layout": autotune_kv_layout(model, force=True),
            "speculation": autotune_speculation(model, force=True),
        }
    if args.out:
        save_registry(args.out)
    out = {
        **verdicts, "platform": model.device.type, "shape": list(shape_key(model)),
        "device_name": torch.cuda.get_device_name(model.device)
        if model.device.type == "cuda" else "cpu",
        "boundary_entry": dict(_REGISTRY[registry_key(model)]),
        "kv_entry": kv_entry(model), "spec_entry": spec_entry(model),
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
