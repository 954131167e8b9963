"""The port's measured decode strategies against the JAX package, on the CPU.

- every axis's resolution order (explicit > env var > registry > default)
  equal to JAX's for the same env and registry;
- the registry file: a save/load round trip in JAX's schema, corrupt files
  loading 0 entries, and JAX's own file loading under JAX's keys;
- each autotuner's verdict and recorded measurements under a scripted
  clock equal to JAX's under the same script: ties, the int8 quality gate,
  the acceptance floor, the skipped full-depth draft;
- the swap-rate registry and the slot engine's use of it;
- the slot engine's ``warmup()``: its refusals, its rebuild onto a KV-layout
  verdict, the verdicts it takes, and tokens unchanged after it.

The model is ``tests/test_speculative.py``'s ``TINY``, its weights JAX's
through the weight bridge.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from perceiver_io_tpu.inference import decode_strategy as jax_strategy
from perceiver_io_tpu.models.text.clm import CausalLanguageModel as JaxCLM
from perceiver_io_tpu.models.text.clm import CausalLanguageModelConfig as JaxConfig
from perceiver_io_tpu_torch.convert.from_jax import load_jax_params
from perceiver_io_tpu_torch.inference import decode_strategy as strategy
from perceiver_io_tpu_torch.inference.generate import GenerationConfig, generate
from perceiver_io_tpu_torch.models.text.clm import CausalLanguageModel, CausalLanguageModelConfig
from perceiver_io_tpu_torch.serving.buckets import BucketTable
from perceiver_io_tpu_torch.serving.engine import ServingEngine
from perceiver_io_tpu_torch.serving.slots import SlotServingEngine

TINY = dict(vocab_size=101, max_seq_len=32, max_latents=8, num_channels=16, num_heads=2,
            num_self_attention_layers=2)
N = 32
CFG = GenerationConfig(max_new_tokens=6, num_latents=2)
TABLE = BucketTable(prompt_lens=(8, 16), batch_sizes=(1,))
ENV_VARS = (strategy.ENV_VAR, strategy.ENV_KV_LAYOUT, strategy.ENV_PREFIX_CACHE,
            strategy.ENV_SPECULATION, strategy.ENV_FILE, strategy.ENV_KV_QUANT_BUDGET,
            "PERCEIVER_FUSED_QKV", "PERCEIVER_FLASH_MIN_KV")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    # tiny shapes: with the suite's workers sharing the cores, one intra-op
    # thread a worker is several times faster than the default
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def pair():
    j_model = JaxCLM(JaxConfig(**TINY))
    init = jax.jit(j_model.init, static_argnums=2)
    params = jax.tree_util.tree_map(
        np.asarray, init(jax.random.PRNGKey(0), jnp.zeros((1, N), jnp.int32), 8)["params"])
    t_model = CausalLanguageModel(CausalLanguageModelConfig(**TINY), device="cpu")
    yield j_model, params, load_jax_params(t_model, params).eval()


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    """Both registries start empty and the shared env vars unset; what was
    in the registries before is put back."""
    for var in ENV_VARS:
        monkeypatch.delenv(var, raising=False)
    names = ("_REGISTRY", "_KV_REGISTRY", "_PREFIX_REGISTRY", "_SPEC_REGISTRY", "_SWAP_REGISTRY")
    saved = [(mod, {n: dict(getattr(mod, n)) for n in names}) for mod in (jax_strategy, strategy)]
    for mod, _ in saved:
        mod.reset_registry()
    yield
    for mod, regs in saved:
        mod.reset_registry()
        for name, entries in regs.items():
            getattr(mod, name).update(entries)


class Script:
    """A clock that returns ``ticks`` in turn (the autotuners read it twice
    per arm: before and after the timed pass)."""

    def __init__(self, ticks):
        self.ticks, self.reads = list(ticks), 0

    def __call__(self) -> float:
        t = self.ticks[self.reads % len(self.ticks)]
        self.reads += 1
        return t


# -- resolution order ---------------------------------------------------------
AXES = {
    # axis: (resolver, recorder, env var, modes to try, a choice to record)
    "boundary": ("resolve", "record", "ENV_VAR", ("cached", "recompute", "auto"), "recompute"),
    "kv_layout": ("resolve_kv_layout", "record_kv_layout", "ENV_KV_LAYOUT",
                  ("dense", "paged", "paged_int8", "auto"), "paged_int8"),
    "prefix_cache": ("resolve_prefix_cache", "record_prefix_cache", "ENV_PREFIX_CACHE",
                     ("on", "off", "auto"), "on"),
    "speculation": ("resolve_speculation", "record_speculation", "ENV_SPECULATION",
                    ("off", "k2d1", "k8d2", "auto"), "k4d2"),
}


@pytest.mark.parametrize("axis", list(AXES))
def test_resolution_order_matches_jax(pair, axis, monkeypatch):
    j_model, _, t_model = pair
    resolver, recorder, env, modes, choice = AXES[axis]

    def both(mode):
        out = []
        for mod, model in ((jax_strategy, j_model), (strategy, t_model)):
            got = getattr(mod, resolver)(mode, model)
            out.append(dataclasses.astuple(got) if axis == "boundary" else got)
        assert out[0] == out[1], (axis, mode, out)
        return out[1]

    untuned = [both(mode) for mode in (None,) + modes]
    monkeypatch.setenv(getattr(strategy, env), modes[1])
    from_env = [both(mode) for mode in (None,) + modes]
    assert from_env[0] == untuned[2]  # the env var beats the default, explicit beats it
    monkeypatch.delenv(getattr(strategy, env))
    for mod, model in ((jax_strategy, j_model), (strategy, t_model)):
        getattr(mod, recorder)(model, choice, note="pinned by test")
    measured = [both(mode) for mode in (None, "auto")]
    assert measured[0] == measured[1] != untuned[0]
    for mod, model in ((jax_strategy, j_model), (strategy, t_model)):
        with pytest.raises(ValueError):
            getattr(mod, resolver)("sometimes", model)
        with pytest.raises(ValueError):
            getattr(mod, recorder)(model, "auto")
    # the port's key: the model's shape, its device type, its two switches
    assert strategy.registry_key(t_model) == (strategy.shape_key(t_model), "cpu", (False, 0))
    assert strategy.shape_key(t_model) == jax_strategy.shape_key(j_model)


def test_constants_match_jax():
    for name in ("MODES", "PHASE_CHOICES", "KV_LAYOUTS", "KV_LAYOUT_CHOICES", "PAGED_KV_LAYOUTS",
                 "PREFIX_CACHE_MODES", "PREFIX_CACHE_CHOICES", "SPECULATION_CHOICES",
                 "SPECULATION_MODES", "ENV_VAR", "ENV_KV_LAYOUT", "ENV_PREFIX_CACHE",
                 "ENV_SPECULATION", "ENV_FILE", "ENV_KV_QUANT_BUDGET", "DEFAULT_KV_QUANT_BUDGET",
                 "DEFAULT_SPEC_ACCEPT_FLOOR"):
        assert getattr(strategy, name) == getattr(jax_strategy, name), name


def test_kv_quant_budget_and_env_file(pair, tmp_path, monkeypatch):
    _, _, t_model = pair
    for raw, want in (("0.25", 0.25), ("bogus", strategy.DEFAULT_KV_QUANT_BUDGET)):
        monkeypatch.setenv(strategy.ENV_KV_QUANT_BUDGET, raw)
        assert strategy.kv_quant_budget() == jax_strategy.kv_quant_budget() == want
    path = str(tmp_path / "deploy.json")
    strategy.record(t_model, "recompute")
    strategy.save_registry(path)
    strategy.reset_registry()
    monkeypatch.setenv(strategy.ENV_FILE, path)
    assert strategy.resolve("auto", t_model).boundary == "recompute"


# -- the registry file --------------------------------------------------------
def test_registry_roundtrip_corrupt_and_jax_files(pair, tmp_path):
    j_model, _, t_model = pair
    files = {}
    for mod, model in ((jax_strategy, j_model), (strategy, t_model)):
        mod.record(model, "recompute", cached_ms_per_token=1.5)
        mod.record_kv_layout(model, "paged", quant_gate={"passed": True})
        mod.record_prefix_cache(model, "on", hit_ratio=0.9)
        mod.record_speculation(model, "k2d1", acceptance={"k2d1": 0.75})
        mod.record_swap_gbps(4.5, platform="cpu", bytes_moved=10)
        files[mod] = str(tmp_path / f"{mod.__name__}.json")
        mod.save_registry(files[mod])
    port_file = json.load(open(files[strategy]))
    jax_file = json.load(open(files[jax_strategy]))
    assert port_file["version"] == jax_file["version"] == 1
    assert set(port_file) == set(jax_file)
    for field in ("entries", "kv_entries", "prefix_entries", "spec_entries", "swap_entries"):
        for mine, theirs in zip(port_file[field], jax_file[field]):
            assert {k: v for k, v in mine.items() if k != "key"} == \
                {k: v for k, v in theirs.items() if k != "key"}
            if field != "swap_entries":
                assert mine["key"]["shape"] == theirs["key"]["shape"]
                assert mine["key"]["env"] == "(False, 0)"
    strategy.reset_registry()
    assert strategy.load_registry(files[strategy]) == 5
    assert (strategy.lookup(t_model), strategy.lookup_kv_layout(t_model),
            strategy.lookup_prefix_cache(t_model), strategy.lookup_speculation(t_model),
            strategy.lookup_swap_gbps("cpu")) == ("recompute", "paged", "on", "k2d1", 4.5)
    assert strategy.kv_entry(t_model)["quant_gate"] == {"passed": True}
    assert strategy.spec_entry(t_model)["acceptance"] == {"k2d1": 0.75}
    assert strategy.swap_entry("cpu") == {"swap_gbps": 4.5, "bytes_moved": 10}
    # a file written before the port read its switches (keys ending in
    # ()) loads under the defaults' fingerprint
    old = dict(port_file, entries=[{**e, "key": {**e["key"], "env": "()"}} for e in port_file["entries"]])
    (tmp_path / "old.json").write_text(json.dumps(old))
    strategy.reset_registry()
    assert strategy.load_registry(str(tmp_path / "old.json")) == 5
    assert strategy.lookup(t_model) == "recompute"
    # JAX's file loads under JAX's keys (its trace-env fingerprint), which
    # the port never looks up; the platform-keyed swap rate is shared
    strategy.reset_registry()
    assert strategy.load_registry(files[jax_strategy]) == 5
    assert strategy.lookup(t_model) is None and strategy.lookup_speculation(t_model) is None
    assert strategy.lookup_swap_gbps("cpu") == 4.5
    strategy.reset_registry()
    for i, bad in enumerate(["{nope", "[]", '{"entries": [42]}', '{"entries": 7}',
                             '{"entries": [{"key": 3, "boundary": "cached"}]}',
                             '{"spec_entries": [{"key": {"shape": [1], "platform": "cpu", '
                             '"env": "()"}, "speculation": "k3d3"}]}',
                             '{"swap_entries": [{"platform": "cpu", "swap_gbps": -1}]}']):
        path = tmp_path / f"bad{i}.json"
        path.write_text(bad)
        assert strategy.load_registry(str(path)) == jax_strategy.load_registry(str(path)) == 0
    assert strategy.load_registry(str(tmp_path / "missing.json")) == 0


def test_registry_key_carries_both_switches(pair, monkeypatch):
    """A verdict recorded with the switches at their defaults is not looked
    up under another setting; the key's third part is JAX's fingerprint's
    first two entries, normalised alike (an unparseable floor is 0)."""
    from perceiver_io_tpu.models.core.modules import trace_env_fingerprint as jax_fingerprint

    _, _, t_model = pair
    strategy.record(t_model, "recompute")
    for fused, min_kv, found in ((None, None, True), ("1", None, False), ("0", "512", False),
                                 (None, "abc", True), ("true", "0", True), ("1", "512", False)):
        for var, value in (("PERCEIVER_FUSED_QKV", fused), ("PERCEIVER_FLASH_MIN_KV", min_kv)):
            if value is None:
                monkeypatch.delenv(var, raising=False)
            else:
                monkeypatch.setenv(var, value)
        assert strategy.registry_key(t_model)[2] == jax_fingerprint()[:2]
        assert (strategy.lookup(t_model) == "recompute") is found, (fused, min_kv)


# -- the autotuners under a scripted clock ------------------------------------
def _entries_equal(mine: dict, theirs: dict) -> None:
    assert set(mine) == set(theirs)
    for key, value in theirs.items():
        if key == "quant_gate":
            assert mine[key]["passed"] == value["passed"]
            assert mine[key]["budget"] == value["budget"]
            assert mine[key]["token_match_rate"] == value["token_match_rate"]
            assert mine[key]["max_logit_delta"] == pytest.approx(value["max_logit_delta"],
                                                                 abs=1e-5)
        else:
            assert mine[key] == value, key


@pytest.mark.parametrize("ticks,want", [
    ([0.0, 0.0], "cached"),  # a frozen clock: the tie goes to cached
    ([0.0, 10.0, 10.0, 11.0], "recompute"),
])
def test_autotune_boundary_matches_jax(pair, ticks, want):
    j_model, params, t_model = pair
    assert jax_strategy.autotune_boundary(j_model, params, clock=Script(ticks)) == want
    clock = Script(ticks)
    assert strategy.autotune_boundary(t_model, clock=clock) == want
    assert clock.reads == 4
    _entries_equal(strategy._REGISTRY[strategy.registry_key(t_model)],
                   jax_strategy._REGISTRY[jax_strategy.registry_key(j_model)])
    reads = clock.reads  # a stored verdict measures nothing
    assert strategy.autotune_boundary(t_model, clock=clock) == want and clock.reads == reads


@pytest.mark.parametrize("ticks,budget,want", [
    ([0.0, 0.0], None, "dense"),  # all tied
    ([0.0, 10.0, 0.0, 5.0, 0.0, 1.0], None, "paged_int8"),  # int8 fastest, gate passed
    ([0.0, 10.0, 0.0, 5.0, 0.0, 1.0], "0", "paged"),  # the same timings, gate failed
    ([0.0, 10.0, 0.0, 5.0, 0.0, 5.0], None, "paged"),  # int8 tied: exact paged
], ids=["tie", "int8", "gate_failed", "int8_tie"])
def test_autotune_kv_layout_matches_jax(pair, ticks, budget, want, monkeypatch, tmp_path):
    j_model, params, t_model = pair
    if budget is not None:
        monkeypatch.setenv(strategy.ENV_KV_QUANT_BUDGET, budget)
    assert jax_strategy.autotune_kv_layout(j_model, params, clock=Script(ticks), new_tokens=4) \
        == want
    path = str(tmp_path / "kv.json")
    clock = Script(ticks)
    assert strategy.autotune_kv_layout(t_model, clock=clock, new_tokens=4, persist=path) == want
    assert clock.reads == 6
    _entries_equal(strategy.kv_entry(t_model), jax_strategy.kv_entry(j_model))
    assert strategy.kv_entry(t_model)["quant_gate"]["passed"] == (budget is None)
    strategy.reset_registry()  # a fresh process: the file's verdict short-circuits
    clock = Script(ticks)
    assert strategy.autotune_kv_layout(t_model, clock=clock, persist=path) == want
    assert clock.reads == 0


@pytest.mark.parametrize("candidates,floor,want", [
    (("k4d1",), strategy.DEFAULT_SPEC_ACCEPT_FLOOR, "k4d1"),  # accepted and faster
    (("k4d1",), 1.01, "off"),  # the floor declines it whatever the timing
    (("k4d2",), strategy.DEFAULT_SPEC_ACCEPT_FLOOR, "off"),  # a full-depth draft: skipped
], ids=["pays", "floor", "full_depth"])
def test_autotune_speculation_matches_jax(pair, candidates, floor, want):
    j_model, params, t_model = pair
    ticks = [0.0, 10.0, 10.0, 11.0]  # "off" 10 s, the draft 1 s
    assert jax_strategy.autotune_speculation(j_model, params, candidates=candidates,
                                             accept_floor=floor, clock=Script(ticks),
                                             new_tokens=4) == want
    clock = Script(ticks)
    assert strategy.autotune_speculation(t_model, candidates=candidates, accept_floor=floor,
                                         clock=clock, new_tokens=4) == want
    _entries_equal(strategy.spec_entry(t_model), jax_strategy.spec_entry(j_model))
    entry = strategy.spec_entry(t_model)
    assert entry["skipped"] == ([] if want != "off" or floor > 1 else list(candidates))
    assert clock.reads == 2 * (1 + len(entry["acceptance"]))
    with pytest.raises(ValueError, match="candidates"):
        strategy.autotune_speculation(t_model, candidates=("off",), force=True)


# -- the swap-rate registry -----------------------------------------------------
def _longtail():
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 101, size=n).astype(np.int32) for n in (5, 7, 6, 4, 7, 5)]
    return prompts, [14 if i % 2 else 3 for i in range(6)]


def test_swap_rate_registry(pair):
    _, _, t_model = pair
    for mod in (jax_strategy, strategy):
        assert mod.lookup_swap_gbps("cpu") is None and mod.swap_entry("cpu") is None
        with pytest.raises(ValueError, match="swap_gbps must be > 0"):
            mod.record_swap_gbps(0.0, platform="cpu")
        assert mod.record_swap_gbps(2.5, platform="cpu", bytes_moved=7) == \
            {"swap_gbps": 2.5, "bytes_moved": 7}
    kw = dict(slots=4, kv_layout="paged", kv_block_size=4, kv_blocks=8, preemption="swap",
              device="cpu")
    table = BucketTable(prompt_lens=(8,), batch_sizes=(1,))
    assert SlotServingEngine(t_model, CFG, table, **kw).swap_link_gbps == 2.5
    assert SlotServingEngine(t_model, CFG, table, swap_link_gbps=9.0, **kw).swap_link_gbps == 9.0
    strategy.reset_registry()

    class Ticker:
        t = 0.0

        def __call__(self):
            self.t += 1e-3
            return self.t

    eng = SlotServingEngine(t_model, CFG, table, clock=Ticker(), **kw)
    assert eng.swap_link_gbps == 16.0  # nothing measured: the prior
    prompts, news = _longtail()
    for p, k in zip(prompts, news):
        eng.submit(p, dataclasses.replace(CFG, max_new_tokens=k))
    eng.run_until_idle()
    assert eng.stats()["preemption"]["swaps"] > 0
    entry = strategy.swap_entry("cpu")
    assert entry["swap_gbps"] == eng.swap_link_gbps != 16.0
    assert entry["bytes_moved"] > 0 and entry["last_transfer_ms"] > 0
    # the next engine on this platform starts from the measured rate
    assert SlotServingEngine(t_model, CFG, table, **kw).swap_link_gbps == eng.swap_link_gbps


# -- the slot engine's warmup ---------------------------------------------------
def _serve_and_check(t_model, eng, lengths=(5, 11, 7, 13)):
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, 101, size=n).astype(np.int32) for n in lengths]
    outs = eng.serve(prompts)
    for p, out in zip(prompts, outs):
        np.testing.assert_array_equal(out, generate(t_model, p[None], CFG, device="cpu")[0].numpy())
    if eng._pool is not None:
        if eng._prefix_index is not None:
            eng._prefix_index.flush(eng._pool)
        assert eng._pool.in_use == 0 and eng._pool.leaked() == 0


def test_warmup_refusals(pair):
    _, _, t_model = pair
    eng = SlotServingEngine(t_model, CFG, TABLE, slots=2, device="cpu")
    with pytest.raises(ValueError, match="must match the engine config"):
        eng.warmup(dataclasses.replace(CFG, num_latents=3))
    eng.submit(np.arange(1, 6, dtype=np.int32))
    eng.step()
    with pytest.raises(RuntimeError, match="resident"):
        eng.warmup()
    eng.run_until_idle()
    assert eng.warmup(dataclasses.replace(CFG, max_new_tokens=2)) > 0
    chunked = SlotServingEngine(t_model, CFG, TABLE, slots=2, prefill_chunk=2, device="cpu")
    chunked.submit(np.arange(1, 14, dtype=np.int32))
    chunked.step()
    assert chunked._admitting is not None
    with pytest.raises(RuntimeError, match="warm up before traffic"):
        chunked.warmup()


def test_warmup_rebuilds_onto_the_kv_verdict(pair):
    _, _, t_model = pair
    eng = SlotServingEngine(t_model, CFG, TABLE, slots=2, kv_layout="auto", prefix_cache="auto",
                            decode_strategy="auto", speculation="auto", device="cpu")
    assert (eng.kv_layout, eng.prefix_cache, eng.speculation) == ("dense", "off", "off")
    assert eng.boundary_mode == "cached"  # pinned at first use ...
    # verdicts recorded after construction: warmup takes them without measuring
    strategy.record(t_model, "recompute")
    strategy.record_kv_layout(t_model, "paged", quant_gate={"passed": False, "budget": 0.0})
    strategy.record_prefix_cache(t_model, "on")
    strategy.record_speculation(t_model, "k2d1")
    assert eng.boundary_mode == "cached"
    old_state = eng._state
    steps = eng.warmup()
    assert eng.boundary_mode == "recompute"  # ... and resolved again by warmup
    assert eng._state is not old_state and eng._pool is not None
    assert (eng.kv_layout, eng.speculation) == ("paged", "k2d1")
    # the preference resolved at construction was off; the verdict came later
    assert eng.prefix_cache == "off" and eng._prefix_index is None
    assert eng.counters["kv_quant_fallback_total"] == 1
    # prefill per bucket (2), decode and boundary variant, the spec round
    assert steps == 5
    _serve_and_check(t_model, eng)
    assert eng.stats()["speculation"]["rounds"] > 0


def test_warmup_prefix_on_over_a_dense_verdict_raises(pair):
    _, _, t_model = pair
    eng = SlotServingEngine(t_model, CFG, TABLE, slots=2, kv_layout="auto", prefix_cache="on",
                            device="cpu")
    strategy.record_kv_layout(t_model, "dense")
    with pytest.raises(ValueError, match="resolved dense"):
        eng.warmup()


@pytest.mark.parametrize("kw,steps", [
    (dict(), 4),
    (dict(kv_layout="paged", kv_block_size=4, prefix_cache="on", prefill_chunk=4,
          preemption="swap", speculation="k4d1"), 11),
    (dict(kv_layout="paged_int8", kv_block_size=4, preemption="auto"), 6),
], ids=["dense", "paged_everything", "int8_auto"])
def test_warmup_then_tokens_unchanged(pair, kw, steps):
    _, _, t_model = pair
    eng = SlotServingEngine(t_model, CFG, TABLE, slots=2, device="cpu", **kw)
    assert eng.warmup() == steps
    assert not eng.pending() and eng.stats()["decode_steps"] == 0
    _serve_and_check(t_model, eng)


def test_bucket_engine_warmup_runs_the_boundary_autotuner(pair):
    _, _, t_model = pair
    eng = ServingEngine(t_model, CFG, BucketTable(prompt_lens=(8,), batch_sizes=(1,)),
                        decode_strategy="auto", device="cpu")
    assert strategy.lookup(t_model) is None
    assert eng.warmup() == 2
    assert strategy.lookup(t_model) in strategy.PHASE_CHOICES
    with pytest.raises(ValueError, match="decode_strategy must be one of"):
        ServingEngine(t_model, CFG, decode_strategy="fastest", device="cpu")
