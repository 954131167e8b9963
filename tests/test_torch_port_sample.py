"""The port's sampled decoding against the JAX package, on the CPU.

A ``torch.Generator`` and JAX's threefry give different streams, so parity
goes through the port's one draw site, ``samplers.gumbel_noise``: the test
rebuilds JAX's keys where JAX splits them and feeds the port
``jax.random.gumbel(key, shape, float32)`` in call order, at JAX's shapes
(``jax.random.categorical`` is ``argmax(gumbel + logits)``):

- ``generate``: ``jax.random.split(PRNGKey(s), max_new_tokens)[t]``;
- the bucket engine: one split of the engine key per micro-batch, then that;
- the slot engine: one split per decode step, ``warmup()``'s two included.

Bars: the filters equal JAX's (top-p's keep set may differ only where
``|cum - probs - p| < 1e-6``, fp32 cumsum order); under the replayed noise
sampled tokens equal JAX's exactly: ``generate()`` over all three phases,
the bucket engine, and the slot engine (dense, paged, chunked, preempted
by recompute). On the port's own generator: empirical frequencies match
``softmax`` of the filtered logits, filtered tokens are never drawn, and
the same seed gives the same tokens.
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perceiver_io_tpu.models.text.clm import CausalLanguageModel as JaxCLM
from perceiver_io_tpu.models.text.clm import CausalLanguageModelConfig as JaxConfig
from perceiver_io_tpu.serving import BucketTable as JaxBucketTable
from perceiver_io_tpu.serving import ServingEngine as JaxServingEngine
from perceiver_io_tpu.serving import SlotServingEngine as JaxSlotServingEngine
from perceiver_io_tpu_torch.convert.from_jax import load_jax_params
from perceiver_io_tpu_torch.inference import samplers
from perceiver_io_tpu_torch.inference.generate import GenerationConfig, generate
from perceiver_io_tpu_torch.models.text.clm import CausalLanguageModel, CausalLanguageModelConfig
from perceiver_io_tpu_torch.serving.buckets import BucketTable
from perceiver_io_tpu_torch.serving.engine import ServingEngine
from perceiver_io_tpu_torch.serving.slots import SlotServingEngine

jax_gen = importlib.import_module("perceiver_io_tpu.inference.generate")
jax_samplers = importlib.import_module("perceiver_io_tpu.inference.samplers")

KW = dict(vocab_size=64, max_seq_len=12, max_latents=6, num_channels=16, num_heads=2,
          num_self_attention_layers=2, init_scale=0.5)
SLOT_KW = dict(vocab_size=71, max_seq_len=32, max_latents=8, num_channels=16, num_heads=2,
               num_self_attention_layers=1, init_scale=0.5)
SAMPLED = dict(do_sample=True, temperature=0.8, top_k=20, top_p=0.9)
#: top-p keep-set differences are excused this close to the boundary
TOP_P_EDGE = 1e-6


def _pair(kw, seq):
    j_model = JaxCLM(config=JaxConfig(**kw))
    params = jax.jit(j_model.init, static_argnames="prefix_len")(
        jax.random.PRNGKey(3), jnp.zeros((1, seq), jnp.int32), prefix_len=seq // 2
    )["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    t_model = CausalLanguageModel(CausalLanguageModelConfig(**kw), device="cpu")
    return j_model, params, load_jax_params(t_model, params).eval()


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
    return _pair(KW, 12)


@pytest.fixture(scope="module")
def slot_pair():
    return _pair(SLOT_KW, 32)


def _jax_config(cfg: GenerationConfig):
    s = cfg.sampling
    return jax_gen.GenerationConfig(
        max_new_tokens=cfg.max_new_tokens, num_latents=cfg.num_latents,
        eos_token_id=cfg.eos_token_id, pad_token_id=cfg.pad_token_id,
        min_new_tokens=cfg.min_new_tokens,
        sampling=jax_samplers.SamplingConfig(
            do_sample=s.do_sample, temperature=s.temperature, top_k=s.top_k, top_p=s.top_p,
            repetition_penalty=s.repetition_penalty),
    )


class Replay:
    """Stands in for ``samplers.gumbel_noise``: each call returns JAX's
    Gumbel draw of the next key, at the shape the port asks for."""

    def __init__(self, keys):
        self.keys = iter(keys)
        self.shapes = []

    def __call__(self, shape, generator, device):
        self.shapes.append(tuple(shape))
        noise = jax.random.gumbel(next(self.keys), tuple(shape), jnp.float32)
        return torch.from_numpy(np.array(noise)).to(device)


def generate_keys(seed: int, steps: int):
    yield from jax.random.split(jax.random.PRNGKey(seed), steps)


def bucket_keys(seed: int, steps_per_batch):
    rng = jax.random.PRNGKey(seed)
    for steps in steps_per_batch:
        rng, key = jax.random.split(rng)
        yield from jax.random.split(key, steps)


def slot_keys(seed: int):
    rng = jax.random.PRNGKey(seed)
    while True:
        rng, key = jax.random.split(rng)
        yield key


def _replay(monkeypatch, keys) -> Replay:
    replay = Replay(keys)
    monkeypatch.setattr(samplers, "gumbel_noise", replay)
    return replay


# -- the filters and one draw ------------------------------------------------
def _logits(seed: int, ties: bool) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if ties:  # few distinct values: ties at every threshold
        return rng.integers(-3, 4, size=(6, 40)).astype(np.float32)
    return (2.0 * rng.standard_normal((6, 40))).astype(np.float32)


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
@pytest.mark.parametrize("k", [1, 5, 40, 100])
def test_top_k_matches_jax(k, ties):
    x = _logits(k, ties)
    want = np.asarray(jax_samplers.apply_top_k(jnp.asarray(x), k))
    got = samplers.apply_top_k(torch.from_numpy(x), k).numpy()
    np.testing.assert_array_equal(got, want)
    assert samplers.NEG_INF == jax_samplers.NEG_INF


def _top_p_edge(x: np.ndarray, p: float) -> np.ndarray:
    """Per row: the logits whose keep decision sits within ``TOP_P_EDGE`` of
    the boundary (``|cum - probs - p|``, in float64)."""
    s = -np.sort(-x.astype(np.float64), axis=-1)
    probs = np.exp(s - s.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    near = np.abs(np.cumsum(probs, -1) - probs - p) < TOP_P_EDGE
    return np.where(near, s, np.nan)


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
@pytest.mark.parametrize("p", [0.0, 0.3, 0.9, 0.999])
def test_top_p_matches_jax(p, ties):
    x = _logits(int(p * 1000) + 7, ties)
    want = np.asarray(jax_samplers.apply_top_p(jnp.asarray(x), p))
    got = samplers.apply_top_p(torch.from_numpy(x), p).numpy()
    edge = _top_p_edge(x, p)
    excused = np.stack([np.isin(x[r], edge[r][~np.isnan(edge[r])]) for r in range(len(x))])
    assert not ((got != want) & ~excused).any()
    assert (got[np.arange(6), x.argmax(-1)] == x.max(-1)).all()  # the argmax survives


SAMPLE_CASES = {
    "greedy": dict(),
    "greedy_penalty": dict(repetition_penalty=1.3),
    "temperature": dict(do_sample=True, temperature=0.7),
    "top_k": dict(do_sample=True, top_k=5),
    "top_p": dict(do_sample=True, top_p=0.9),
    "top_p_zero": dict(do_sample=True, top_p=0.0),
    "combined": dict(do_sample=True, temperature=0.7, top_k=8, top_p=0.9, repetition_penalty=1.2),
}


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
@pytest.mark.parametrize("case", list(SAMPLE_CASES))
def test_sample_logits_matches_jax(case, ties, monkeypatch):
    x = _logits(3, ties)
    ctx = np.random.default_rng(1).integers(0, 40, size=(6, 9)).astype(np.int32)
    mask = np.zeros_like(ctx, bool)
    mask[:, :3] = True
    key = jax.random.PRNGKey(17)
    j_cfg = jax_samplers.SamplingConfig(**SAMPLE_CASES[case])
    t_cfg = samplers.SamplingConfig(**SAMPLE_CASES[case])
    want = np.asarray(jax_samplers.sample_logits(key, jnp.asarray(x), j_cfg, jnp.asarray(ctx),
                                                 jnp.asarray(mask)))
    replay = _replay(monkeypatch, [key])
    got = samplers.sample_logits(torch.from_numpy(x), t_cfg, torch.from_numpy(ctx),
                                 torch.from_numpy(mask), generator=torch.Generator()).numpy()
    np.testing.assert_array_equal(got, want)
    assert replay.shapes == ([x.shape] if t_cfg.do_sample else [])


# -- sampled generate() ------------------------------------------------------
# (prompt_len, pads, num_latents, new_tokens, kwargs): the phase plans of
# tests/test_torch_port_serving.py, sampled
GEN_CASES = {
    "all_phases_cached": (4, None, 2, 14, dict(decode_strategy="cached")),
    "all_phases_recompute": (4, None, 2, 14, dict(decode_strategy="recompute")),
    "no_cache": (4, None, 2, 10, dict(use_cache=False)),
    "padded_all_phases": (8, (2, 0), 3, 10, dict()),
    "padded_past_prefix": (8, (4, 0), 6, 8, dict()),
    "eos_min_new_penalty": (5, None, 3, 9, dict(eos=61, min_new=3, penalty=1.3)),
}


@pytest.mark.parametrize("case", list(GEN_CASES))
def test_sampled_generate_matches_jax(pair, case, monkeypatch):
    j_model, params, t_model = pair
    prompt_len, pads, num_latents, new_tokens, kw = GEN_CASES[case]
    kw = dict(kw)
    ids = np.random.default_rng(11).integers(1, 64, (2, prompt_len)).astype(np.int32)
    cfg = GenerationConfig(
        max_new_tokens=new_tokens, num_latents=num_latents,
        eos_token_id=kw.pop("eos", None), min_new_tokens=kw.pop("min_new", 0),
        sampling=samplers.SamplingConfig(**SAMPLED, repetition_penalty=kw.pop("penalty", 1.0)),
    )
    pad = None if pads is None else np.asarray(pads, np.int32)
    expected = np.asarray(jax_gen.generate(
        j_model, params, jnp.asarray(ids), _jax_config(cfg), rng=jax.random.PRNGKey(5),
        prompt_pad_count=None if pad is None else jnp.asarray(pad), **kw,
    ))
    replay = _replay(monkeypatch, generate_keys(5, new_tokens))
    actual = generate(t_model, ids, cfg, prompt_pad_count=pad, device="cpu", **kw).numpy()
    assert replay.shapes == [(2, 64)] * new_tokens  # one (b, V) draw a step
    np.testing.assert_array_equal(actual, expected)
    if cfg.eos_token_id is not None:
        assert (actual == cfg.eos_token_id).any()  # the script reaches EOS


# -- the bucket engine -------------------------------------------------------
def test_sampled_bucket_engine_matches_jax(pair, monkeypatch):
    # two configs -> two micro-batches in order, each padded to batch 4
    j_model, params, t_model = pair
    rng = np.random.default_rng(5)
    cfg_a = GenerationConfig(max_new_tokens=7, num_latents=2,
                             sampling=samplers.SamplingConfig(**SAMPLED))
    cfg_b = GenerationConfig(max_new_tokens=5, num_latents=6,
                             sampling=samplers.SamplingConfig(do_sample=True, temperature=1.3))
    script = [(3, cfg_a), (8, cfg_b), (5, cfg_a), (11, cfg_b)]
    prompts = [rng.integers(1, 64, (n,)).astype(np.int32) for n, _ in script]
    grid = dict(prompt_lens=(8, 12), batch_sizes=(1, 4))

    j_eng = JaxServingEngine(j_model, params, table=JaxBucketTable(**grid), rng=jax.random.PRNGKey(9))
    j_reqs = [j_eng.submit(p, _jax_config(c)) for p, (_, c) in zip(prompts, script)]
    j_eng.run_until_idle()
    replay = _replay(monkeypatch, bucket_keys(9, (7, 5)))
    t_eng = ServingEngine(t_model, table=BucketTable(**grid), device="cpu")
    t_reqs = [t_eng.submit(p, c) for p, (_, c) in zip(prompts, script)]
    t_eng.run_until_idle()
    assert replay.shapes == [(4, 64)] * 7 + [(4, 64)] * 5  # the bucket's padded batch
    for j_req, t_req in zip(j_reqs, t_reqs):
        assert t_req.status == j_req.status == "ok"
        np.testing.assert_array_equal(t_req.result, np.asarray(j_req.result))


def test_bucket_engine_serve_takes_the_callers_generator(pair):
    _, _, t_model = pair
    cfg = GenerationConfig(max_new_tokens=6, num_latents=3, sampling=samplers.SamplingConfig(**SAMPLED))
    prompts = [np.arange(1, 6, dtype=np.int32), np.arange(3, 10, dtype=np.int32)]
    eng = ServingEngine(t_model, cfg, table=BucketTable((8,), (2,)), device="cpu")
    first = eng.serve(prompts, generator=torch.Generator().manual_seed(4))
    again = eng.serve(prompts, generator=torch.Generator().manual_seed(4))
    for a, b in zip(first, again):
        np.testing.assert_array_equal(a, b)
    # the engine's own generator (seed 0) is generate()'s default stream
    fresh = ServingEngine(t_model, cfg, table=BucketTable((8,), (2,)), device="cpu")
    ids = np.stack([np.pad(p, (8 - p.size, 0)) for p in prompts]).astype(np.int32)
    alone = generate(t_model, ids, cfg, prompt_pad_count=np.array([3, 1]), device="cpu").numpy()
    np.testing.assert_array_equal(np.stack(fresh.serve(prompts)), alone)


# -- the slot engine ---------------------------------------------------------
SLOT_CFG = GenerationConfig(max_new_tokens=10, num_latents=2,
                            sampling=samplers.SamplingConfig(**SAMPLED))
SLOT_LENS, SLOT_NEWS = [3, 11, 8, 3, 11], [10, 4, 10, 7, 10]
# (engine kwargs, warmup first): 5 requests through 2 slots, rows crossing
# into the boundary phase at different steps; then a pressured pool
SLOT_CASES = {
    "dense": (dict(), True),
    "paged": (dict(kv_layout="paged", kv_block_size=8), False),
    "paged_chunked": (dict(kv_layout="paged", kv_block_size=8, prefill_chunk=4), False),
    "paged_recompute": (dict(kv_layout="paged", kv_block_size=4, kv_blocks=10, slots=3,
                             preemption="recompute", admit_headroom_blocks=0), False),
}


@pytest.mark.parametrize("case", list(SLOT_CASES))
def test_sampled_slot_engine_matches_jax(slot_pair, case, monkeypatch):
    j_model, params, t_model = slot_pair
    kw, warm = SLOT_CASES[case]
    kw = dict(kw)
    slots = kw.pop("slots", 2)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 71, size=n).astype(np.int32) for n in SLOT_LENS]
    news = SLOT_NEWS if "preemption" not in kw else [14, 3, 14, 3, 14]
    table = dict(prompt_lens=(8, 16), batch_sizes=(1,))

    def run(engine, cfg):
        if warm:
            engine.warmup()
        reqs = [engine.submit(p, dataclasses.replace(cfg, max_new_tokens=k))
                for p, k in zip(prompts, news)]
        engine.run_until_idle()
        return reqs

    j_cfg = _jax_config(SLOT_CFG)
    j_eng = JaxSlotServingEngine(j_model, params, j_cfg, JaxBucketTable(**table), slots=slots,
                                 rng=jax.random.PRNGKey(21), **kw)
    j_reqs = run(j_eng, j_cfg)
    replay = _replay(monkeypatch, slot_keys(21))
    eng = SlotServingEngine(t_model, SLOT_CFG, BucketTable(**table), slots=slots, device="cpu", **kw)
    reqs = run(eng, SLOT_CFG)
    stats, j_stats = eng.stats(), j_eng.stats()
    # one (S, V) draw a decode step, idle slots included; warmup's two first
    assert replay.shapes == [(slots, 71)] * (stats["decode_steps"] + 2 * warm)
    for j_req, req in zip(j_reqs, reqs):
        assert req.status == j_req.status == "ok"
        np.testing.assert_array_equal(req.result, np.asarray(j_req.result))
    for key in ("decode_steps", "prefills", "prefill_chunks"):
        assert stats[key] == j_stats[key], key
    assert stats["boundary_steps"] > 0  # rows crossed into the boundary phase
    if "preemption" in kw:
        assert stats["preemption"]["preemptions"] == j_stats["preemption"]["preemptions"] >= 1
    if eng._pool is not None:
        assert eng._pool.in_use == 0 and eng._pool.leaked() == 0


def test_slot_engine_speculation_still_refuses_sampling(slot_pair):
    _, _, t_model = slot_pair
    with pytest.raises(ValueError, match="greedy-only"):
        SlotServingEngine(t_model, SLOT_CFG, BucketTable((8, 16), (1,)), slots=2,
                          speculation="k2d1", device="cpu")


# -- the port's own generator ------------------------------------------------
def test_draws_follow_the_filtered_distribution():
    logits = torch.tensor([[2.0, 1.5, 1.0, 0.5, 0.0, -0.5, -1.0, -3.0]])
    cfg = samplers.SamplingConfig(do_sample=True, temperature=0.9, top_k=6, top_p=0.95)
    filtered = samplers.filter_logits(logits, cfg)
    probs = torch.softmax(filtered, dim=-1)[0].double().numpy()
    n = 40000
    draws = samplers.sample_logits(logits.expand(n, -1), cfg,
                                   generator=torch.Generator().manual_seed(0)).numpy()
    freq = np.bincount(draws, minlength=8) / n
    assert (freq[probs == 0] == 0).all() and (probs == 0).sum() >= 2  # filtered: never drawn
    sigma = np.sqrt(probs * (1 - probs) / n)
    assert (np.abs(freq - probs) <= 5 * sigma + 1e-12).all(), (freq, probs)


def test_same_seed_same_tokens(pair):
    _, _, t_model = pair
    ids = np.random.default_rng(2).integers(1, 64, (3, 5)).astype(np.int32)
    cfg = GenerationConfig(max_new_tokens=12, num_latents=2,
                           sampling=samplers.SamplingConfig(do_sample=True, temperature=1.5))

    def run(seed):
        return generate(t_model, ids, cfg, generator=torch.Generator().manual_seed(seed),
                        device="cpu").numpy()

    np.testing.assert_array_equal(run(7), run(7))
    assert (run(7) != run(8)).any()
    # no generator: seed 0, as JAX defaults to PRNGKey(0)
    np.testing.assert_array_equal(generate(t_model, ids, cfg, device="cpu").numpy(), run(0))
    # top_k=1 samples the argmax: greedy
    greedy = generate(t_model, ids, dataclasses.replace(cfg, sampling=samplers.SamplingConfig()),
                      device="cpu").numpy()
    top1 = dataclasses.replace(cfg, sampling=samplers.SamplingConfig(do_sample=True, top_k=1))
    np.testing.assert_array_equal(generate(t_model, ids, top1, device="cpu").numpy(), greedy)
