"""The port's speculative decoding against the JAX package, on the CPU.

- ``draft_forward`` and ``verify_lanes`` logits at fp32 1e-5 over rows whose
  latent counts differ (latent growth, the ``m == max_latents`` boundary, a
  crossing mid-burst, the sliding window); ``propose_tokens``,
  ``accept_prefix`` and ``advance_window`` exactly equal;
- ``speculative_generate`` token-identical to JAX's and to ``generate()``;
- the slot engine with speculation token-identical to the JAX
  ``SlotServingEngine``, with equal speculation, pool and preemption
  counters and 0 leaked, under dense, paged, paged_int8, chunked prefill
  with prefix sharing, and preemption by recompute and by swap;
- burst tokens reach ``on_token`` one call each, in order, and TTFT plus
  the ITL samples add up to each stream's span;
- the loud rejects.

The model is ``tests/test_speculative.py``'s ``TINY``, its weights JAX's
through the weight bridge; the JAX engine runs are shared per module.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perceiver_io_tpu.inference import decode_strategy as jax_strategy
from perceiver_io_tpu.inference import speculative as jax_spec
from perceiver_io_tpu.inference.generate import GenerationConfig as JaxGenerationConfig
from perceiver_io_tpu.inference.generate import generate as jax_generate
from perceiver_io_tpu.models.text.clm import CausalLanguageModel as JaxCLM
from perceiver_io_tpu.models.text.clm import CausalLanguageModelConfig as JaxConfig
from perceiver_io_tpu.serving import BucketTable as JaxBucketTable
from perceiver_io_tpu.serving import SlotServingEngine as JaxSlotServingEngine
from perceiver_io_tpu_torch.convert.from_jax import load_jax_params
from perceiver_io_tpu_torch.inference import decode_strategy as port_strategy
from perceiver_io_tpu_torch.inference import speculative as spec
from perceiver_io_tpu_torch.inference.generate import GenerationConfig, generate
from perceiver_io_tpu_torch.inference.samplers import SamplingConfig
from perceiver_io_tpu_torch.models.text.clm import CausalLanguageModel, CausalLanguageModelConfig
from perceiver_io_tpu_torch.serving.buckets import BucketTable
from perceiver_io_tpu_torch.serving.slots import SlotServingEngine

TINY = dict(vocab_size=101, max_seq_len=32, max_latents=8, num_channels=16, num_heads=2,
            num_self_attention_layers=2)
N, L = 32, 8
CFG = GenerationConfig(max_new_tokens=10, num_latents=2)
J_CFG = JaxGenerationConfig(max_new_tokens=10, num_latents=2)


class Frozen:
    """A clock that moves only when told to."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


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
def _clean_registries(monkeypatch):
    """Both packages resolve "auto" and default modes through their
    registries and the same env vars: neither may leak into these runs."""
    for var in (port_strategy.ENV_SPECULATION, port_strategy.ENV_KV_LAYOUT,
                port_strategy.ENV_PREFIX_CACHE, port_strategy.ENV_VAR, port_strategy.ENV_FILE):
        monkeypatch.delenv(var, raising=False)
    saved = [(mod, {name: dict(getattr(mod, name)) for name in (
        "_REGISTRY", "_KV_REGISTRY", "_PREFIX_REGISTRY", "_SPEC_REGISTRY", "_SWAP_REGISTRY")})
        for mod in (jax_strategy, port_strategy)]
    for mod in (jax_strategy, port_strategy):
        mod.reset_registry()
    yield
    for mod, regs in saved:
        mod.reset_registry()
        for name, entries in regs.items():
            getattr(mod, name).update(entries)


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 101, size=int(n)).astype(np.int32) for n in lengths]


def _lane_state():
    """Four rows: latent growth (m 2), the boundary (m 8), a crossing
    mid-burst (m 6) and the sliding window (pad 0, m 8)."""
    rng = np.random.default_rng(7)
    window = rng.integers(1, 101, size=(4, N)).astype(np.int32)
    pad = np.array([27, 12, 18, 0], np.int32)
    for r, p in enumerate(pad):
        window[r, :p] = 0
    m = np.array([2, 8, 6, 8], np.int32)
    return window, pad, m


def _j_apply(pair, method, *args, static=()):
    """``method`` of the JAX model under ``jax.jit`` (eager JAX on the CPU
    is several times slower); ``static`` are the positions of ``args`` that
    are compile-time constants."""
    j_model, params, _ = pair
    run = jax.jit(lambda p, *a: j_model.apply({"params": p}, *a, method=method),
                  static_argnums=tuple(1 + i for i in static))
    return run(params, *args)


def _t(x):
    return torch.as_tensor(np.asarray(x)).long()


@pytest.mark.parametrize("draft_layers", [1, 2])
def test_draft_forward_matches_jax(pair, draft_layers):
    window, pad, m = _lane_state()
    ref = _j_apply(pair, jax_spec.draft_forward, jnp.asarray(window), jnp.asarray(pad),
                   jnp.asarray(m), draft_layers, static=(3,))
    with torch.no_grad():
        got = spec.draft_forward(pair[2], _t(window), _t(pad), _t(m), draft_layers)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("k", [1, 4])
def test_verify_lanes_match_jax(pair, k):
    """The lanes at per-row latent counts: rows 0 (growth), 1 (boundary),
    2 (crossing at lane 1) and 3 (window)."""
    window, pad, m = _lane_state()
    cand = np.random.default_rng(k).integers(1, 101, size=(4, k + 1)).astype(np.int32)
    ref = _j_apply(pair, jax_spec.verify_lanes, jnp.asarray(window), jnp.asarray(pad),
                   jnp.asarray(m), jnp.asarray(cand))
    with torch.no_grad():
        got = spec.verify_lanes(pair[2], _t(window), _t(pad), _t(m), _t(cand))
    assert got.shape == (4, k + 1, 101)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


def test_propose_accept_advance_equal_jax(pair):
    window, pad, m = _lane_state()
    steps = np.array([0, 3, 1, 5], np.int32)
    logits = np.random.default_rng(3).standard_normal((4, 101)).astype(np.float32)
    args = (jnp.asarray(window), jnp.asarray(pad), jnp.asarray(m), jnp.asarray(steps),
            jnp.asarray(logits))
    # min_new 3 with EOS 5 masks EOS at the rows' early steps
    j_cand = np.asarray(_j_apply(pair, jax_spec.propose_tokens, *args, 4, 1, 3, 5,
                                 static=(5, 6, 7, 8)))
    with torch.no_grad():
        cand = spec.propose_tokens(pair[2], _t(window), _t(pad), _t(m), _t(steps),
                                   torch.from_numpy(logits), 4, 1, 3, 5)
    np.testing.assert_array_equal(cand.numpy(), j_cand)
    # lane logits that accept 0, 2 and 4 drafts, and one row that EOS-masks
    lane = np.random.default_rng(4).standard_normal((4, 5, 101)).astype(np.float32)
    for r, accept in enumerate((0, 2, 4, 4)):
        for j in range(accept):
            lane[r, j, j_cand[r, j + 1]] = 50.0
    lane[2, 0, 5] = 99.0  # EOS at row 2's step 2 < min_new: masked, so the draft still wins
    j_ne, j_next = jax_spec.accept_prefix(jnp.asarray(lane), jnp.asarray(j_cand),
                                          jnp.asarray(steps), 3, 5)
    n_e, nxt = spec.accept_prefix(torch.from_numpy(lane), cand, _t(steps), 3, 5)
    np.testing.assert_array_equal(n_e.numpy(), np.asarray(j_ne))
    assert n_e.tolist()[:3] == [1, 3, 5]
    np.testing.assert_array_equal(nxt.numpy(), np.asarray(j_next))
    j_adv = jax_spec.advance_window(jnp.asarray(window), jnp.asarray(pad), jnp.asarray(m),
                                    jnp.asarray(j_cand), j_ne, L)
    adv = spec.advance_window(_t(window), _t(pad), _t(m), cand, n_e, L)
    for got, ref in zip(adv, j_adv):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("k,d", [(1, 1), (2, 1), (4, 1), (1, 2), (2, 2), (4, 2)])
def test_speculative_generate_token_identical(pair, k, d):
    """Against the port's ``generate()`` and JAX's, over prompts straddling
    the latent boundary and a ragged batch whose rows accept different
    bursts; with an EOS that stops a row mid-burst."""
    j_model, params, t_model = pair
    cfg = dataclasses.replace(CFG, eos_token_id=7, min_new_tokens=2)
    j_cfg = dataclasses.replace(J_CFG, eos_token_id=7, min_new_tokens=2)
    prompts = _prompts(0, [3, 11, 8])
    for p in prompts:
        ref = generate(t_model, p[None], cfg, device="cpu")[0].numpy()
        j_ref = np.asarray(jax_generate(j_model, params, jnp.asarray(p[None]), j_cfg))[0]
        np.testing.assert_array_equal(ref, j_ref)
        got = spec.speculative_generate(t_model, p[None], cfg, spec.SpecConfig(k, d),
                                        device="cpu")[0].numpy()
        np.testing.assert_array_equal(got, ref, err_msg=f"k{k}d{d}")
    batch = np.stack(_prompts(1, [7, 7]))
    got = spec.speculative_generate(t_model, batch, cfg, spec.SpecConfig(k, d), device="cpu")
    np.testing.assert_array_equal(got.numpy(), generate(t_model, batch, cfg, device="cpu").numpy())


def test_speculative_generate_equals_jax_speculative(pair):
    j_model, params, t_model = pair
    batch = np.stack(_prompts(1, [7, 7]))
    ref = jax_spec.speculative_generate(j_model, params, jnp.asarray(batch), J_CFG,
                                        jax_spec.SpecConfig(4, 1))
    got = spec.speculative_generate(t_model, batch, CFG, spec.SpecConfig(4, 1), device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# -- the slot engine against JAX's --------------------------------------------
def _shared(seed):
    """Prompts sharing an 8-token head (two full blocks of 4), for prefix hits."""
    head = _prompts(seed, [8])[0]
    return [np.concatenate([head, p]).astype(np.int32) for p in _prompts(seed + 1, [4, 6, 2, 5, 3])]


def _longtail():
    """``tests/test_torch_port_preempt.py``'s pressured script: shorts and
    near-context longs over 8 blocks of 4, lazy admission."""
    return _prompts(3, [5, 7, 6, 4, 7, 5]), [14 if i % 2 else 3 for i in range(6)]


SCRIPTS = {
    "dense": (_prompts(0, [3, 11, 8, 3, 11]), None, dict()),
    "paged": (_prompts(0, [3, 11, 8, 3, 11]), None, dict(kv_layout="paged", kv_block_size=4)),
    "paged_int8": (_prompts(0, [3, 11, 8, 3, 11]), None,
                   dict(kv_layout="paged_int8", kv_block_size=4)),
    "chunked_shared": (_shared(5), None, dict(kv_layout="paged", kv_block_size=4,
                                              prefix_cache="on", prefill_chunk=4)),
    "preempt_recompute": (*_longtail(), dict(kv_layout="paged", kv_block_size=4, kv_blocks=8,
                                             slots=4, preemption="recompute", table=(8,))),
    "preempt_swap": (*_longtail(), dict(kv_layout="paged", kv_block_size=4, kv_blocks=8, slots=4,
                                        preemption="swap", table=(8,))),
}
_RUNS = {}


def _run(pair, name):
    """Both engines over script ``name`` with ``speculation="k4d1"`` (once
    per module)."""
    if name in _RUNS:
        return _RUNS[name]
    prompts, news, kw = SCRIPTS[name]
    kw = dict(kw)
    table = kw.pop("table", (8, 16))
    common = dict(slots=kw.pop("slots", 2), speculation="k4d1", clock=Frozen(), **kw)
    news = news or [10] * len(prompts)
    j_model, params, t_model = pair
    j_eng = JaxSlotServingEngine(j_model, params, J_CFG,
                                 JaxBucketTable(prompt_lens=table, batch_sizes=(1,)), **common)
    j_reqs = [j_eng.submit(p, config=dataclasses.replace(J_CFG, max_new_tokens=k))
              for p, k in zip(prompts, news)]
    j_eng.run_until_idle()
    eng = SlotServingEngine(t_model, CFG, BucketTable(prompt_lens=table, batch_sizes=(1,)),
                            device="cpu", **common)
    reqs = [eng.submit(p, config=dataclasses.replace(CFG, max_new_tokens=k))
            for p, k in zip(prompts, news)]
    eng.run_until_idle()
    _RUNS[name] = (j_eng, j_reqs, eng, reqs, news)
    return _RUNS[name]


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_slot_engine_speculation_matches_jax(pair, name):
    j_eng, j_reqs, eng, reqs, news = _run(pair, name)
    t_model = pair[2]
    for j_req, req, k in zip(j_reqs, reqs, news):
        assert j_req.status == "ok" and req.status == "ok"
        ref = generate(t_model, req.prompt[None], dataclasses.replace(CFG, max_new_tokens=k),
                       device="cpu")[0].numpy()
        np.testing.assert_array_equal(req.result, ref)
        np.testing.assert_array_equal(req.result, np.asarray(j_req.result))
        assert req.preemptions == j_req.preemptions
    stats, j_stats = eng.stats(), j_eng.stats()
    for key in ("mode", "k", "draft_layers", "rounds", "proposed", "accepted", "emitted",
                "acceptance_rate", "tokens_per_round"):
        assert stats["speculation"][key] == j_stats["speculation"][key], key
    assert stats["speculation"]["emitted"] == sum(len(r.result) for r in reqs)
    assert stats["speculation"]["accepted"] <= stats["speculation"]["proposed"]
    for key in ("decode_steps", "prefills", "prefill_chunks", "tokens_generated"):
        assert stats[key] == j_stats[key], key
    if "kv_pool" in j_stats:
        for key in ("allocs_total", "frees_total", "frees_by_cause", "high_water", "in_use",
                    "leaked", "lazy_slots", "shared_maps_total", "shared_derefs_total"):
            assert stats["kv_pool"][key] == j_stats["kv_pool"][key], key
        for key in ("preemptions", "readmissions", "swaps", "swap_restores", "swap_bytes",
                    "swapped_waiting"):
            assert stats["preemption"][key] == j_stats["preemption"][key], key
        if j_stats["prefix_cache"]["enabled"]:
            assert stats["prefix_cache"]["hits"] == j_stats["prefix_cache"]["hits"] > 0
            eng._prefix_index.flush(eng._pool)
        assert eng._pool.in_use == 0 and eng._pool.leaked() == 0
    if name.startswith("preempt"):
        assert stats["preemption"]["preemptions"] > 0
        if name.endswith("swap"):
            assert stats["preemption"]["swaps"] > 0


def test_burst_tokens_stream_and_telescope(pair):
    """Each accepted token reaches ``on_token`` once, indices in order; one
    TTFT sample per request and one ITL sample per later token, and their
    sum is each stream's span, first submit to last token."""
    t_model = pair[2]
    clock = Frozen()
    eng = SlotServingEngine(t_model, dataclasses.replace(CFG, max_new_tokens=8),
                            BucketTable(prompt_lens=(8,), batch_sizes=(1,)), slots=2,
                            speculation="k4d1", clock=clock, device="cpu")
    streams, last_at = {}, {}
    reqs = []
    for i, p in enumerate(_prompts(3, [5, 7, 6, 4])):
        streams[i] = []

        def sink(idx, tok, i=i):
            streams[i].append((idx, tok))
            last_at[i] = clock()

        reqs.append(eng.submit(p, on_token=sink))
    while eng.pending():
        eng.step()
        clock.t += 0.01
    emitted = sum(len(r.result) for r in reqs)
    for i, r in enumerate(reqs):
        assert [idx for idx, _ in streams[i]] == list(range(len(r.result)))
        assert [tok for _, tok in streams[i]] == [int(t) for t in r.result]
    ttft, itl = eng.samples["ttft_ms"], eng.samples["inter_token_ms"]
    assert len(ttft) == len(reqs) and len(ttft) + len(itl) == emitted
    assert 0.0 in itl  # a burst's later tokens
    span = sum((last_at[i] - r.submitted_at) * 1e3 for i, r in enumerate(reqs))
    assert sum(ttft) + sum(itl) == pytest.approx(span, abs=1e-6)
    assert eng.stats()["speculation"]["emitted"] == emitted


def test_loud_rejects(pair):
    j_model, params, t_model = pair
    table = BucketTable(prompt_lens=(8,), batch_sizes=(1,))
    sampled = dataclasses.replace(CFG, sampling=SamplingConfig(do_sample=True))
    with pytest.raises(ValueError, match="greedy-only"):
        SlotServingEngine(t_model, sampled, table, slots=2, speculation="k4d1", device="cpu")
    with pytest.raises(ValueError, match="speculation must be one of"):
        SlotServingEngine(t_model, CFG, table, slots=2, speculation="bogus", device="cpu")
    with pytest.raises(ValueError, match="repetition_penalty"):
        spec.validate_spec(spec.SpecConfig(4, 1), t_model,
                           dataclasses.replace(CFG, sampling=SamplingConfig(repetition_penalty=1.2)))
    with pytest.raises(ValueError, match="num_beams must be 1"):
        spec.validate_spec(spec.SpecConfig(4, 1), t_model, dataclasses.replace(CFG, num_beams=2))
    with pytest.raises(ValueError, match="draft_layers"):
        spec.validate_spec(spec.SpecConfig(4, 3), t_model, CFG)
    with pytest.raises(ValueError, match="draft_layers"):
        jax_spec.validate_spec(jax_spec.SpecConfig(4, 3), j_model, J_CFG)
    with pytest.raises(ValueError, match="'off' or 'k<K>d<D>'"):
        spec.parse_speculation("k4")
    with pytest.raises(ValueError, match="k must be >= 1"):
        spec.SpecConfig(0, 1)
    assert spec.parse_speculation("off") is None and spec.parse_speculation("k8d2").mode == "k8d2"
