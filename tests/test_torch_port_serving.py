"""Port generation and serving against the JAX package, on the CPU: greedy
token identity with JAX ``generate()`` across every phase crossing (cached,
recompute, no cache, left-padded batches), ``ServingEngine`` token identity
with the JAX engine on a ragged request script, and the engine's queue,
deadline and health contracts. Tiny config (vocab 64, max_seq_len 12,
max_latents 6, 16 channels, 2 heads, 2 layers), fp32; tokens must be equal.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perceiver_io_tpu.models.text.clm import CausalLanguageModel as JaxCLM
from perceiver_io_tpu.models.text.clm import CausalLanguageModelConfig as JaxConfig
from perceiver_io_tpu.serving import engine as jax_engine
from perceiver_io_tpu.serving.buckets import BucketTable as JaxBucketTable
from perceiver_io_tpu_torch.convert.from_jax import load_jax_params
from perceiver_io_tpu_torch.inference.generate import GenerationConfig, generate
from perceiver_io_tpu_torch.inference.samplers import SamplingConfig
from perceiver_io_tpu_torch.models.text.clm import CausalLanguageModel, CausalLanguageModelConfig
from perceiver_io_tpu_torch.reliability import QueueFull
from perceiver_io_tpu_torch.serving.buckets import BucketTable
from perceiver_io_tpu_torch.serving.engine import HEALTH_KEYS, ServingEngine

jax_gen = importlib.import_module("perceiver_io_tpu.inference.generate")

KW = dict(vocab_size=64, max_seq_len=12, max_latents=6, num_channels=16, num_heads=2,
          num_self_attention_layers=2, init_scale=0.5)


@pytest.fixture(scope="module")
def pair():
    j_model = JaxCLM(config=JaxConfig(**KW))
    params = jax.jit(j_model.init, static_argnames="prefix_len")(
        jax.random.PRNGKey(3), jnp.zeros((1, 12), jnp.int32), prefix_len=6
    )["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    t_model = CausalLanguageModel(CausalLanguageModelConfig(**KW), device="cpu")
    return j_model, params, load_jax_params(t_model, params).eval()


def _jax_config(cfg: GenerationConfig):
    return jax_gen.GenerationConfig(
        max_new_tokens=cfg.max_new_tokens, num_latents=cfg.num_latents,
        eos_token_id=cfg.eos_token_id, pad_token_id=cfg.pad_token_id,
        min_new_tokens=cfg.min_new_tokens,
        sampling=jax_gen.SamplingConfig(repetition_penalty=cfg.sampling.repetition_penalty),
    )


# (prompt_len, pads, num_latents, new_tokens, kwargs): the phase plans
GEN_CASES = {
    # latent growth -> prefix growth -> sliding window
    "all_phases_cached": (4, None, 2, 14, dict(decode_strategy="cached")),
    "all_phases_recompute": (4, None, 2, 14, dict(decode_strategy="recompute")),
    "no_cache": (4, None, 2, 10, dict(use_cache=False)),
    # left-padded batch whose pads fit the nominal prefix: all three phases
    "padded_all_phases": (8, (2, 0), 3, 10, dict()),
    # pads beyond the nominal prefix: the boundary phase is recomputed
    "padded_past_prefix": (8, (4, 0), 6, 8, dict()),
    # EOS, min_new_tokens and the repetition penalty on the greedy path
    "eos_penalty": (5, None, 3, 9, dict(eos=7, min_new=3, penalty=1.3)),
}


@pytest.mark.parametrize("case", list(GEN_CASES))
def test_generate_token_identity(pair, case):
    j_model, params, t_model = pair
    prompt_len, pads, num_latents, new_tokens, kw = GEN_CASES[case]
    kw = dict(kw)
    ids = np.random.default_rng(11).integers(1, 64, (2, prompt_len)).astype(np.int32)
    cfg = GenerationConfig(
        max_new_tokens=new_tokens, num_latents=num_latents,
        eos_token_id=kw.pop("eos", None), min_new_tokens=kw.pop("min_new", 0),
        sampling=SamplingConfig(repetition_penalty=kw.pop("penalty", 1.0)),
    )
    pad = None if pads is None else np.asarray(pads, np.int32)
    expected = jax_gen.generate(
        j_model, params, jnp.asarray(ids), _jax_config(cfg),
        prompt_pad_count=None if pad is None else jnp.asarray(pad), **kw,
    )
    actual = generate(t_model, ids, cfg, prompt_pad_count=pad, device="cpu", **kw)
    np.testing.assert_array_equal(actual.numpy(), np.asarray(expected))


def test_engine_matches_jax_engine(pair):
    # a ragged 4-request script over two configs -> two micro-batches in two
    # buckets, left-padded rows and a filler row included
    j_model, params, t_model = pair
    rng = np.random.default_rng(5)
    cfg_a = GenerationConfig(max_new_tokens=7, num_latents=2)
    cfg_b = GenerationConfig(max_new_tokens=5, num_latents=6)
    script = [(3, cfg_a), (8, cfg_b), (5, cfg_a), (11, cfg_b)]
    prompts = [rng.integers(1, 64, (n,)).astype(np.int32) for n, _ in script]
    grid = dict(prompt_lens=(8, 12), batch_sizes=(1, 4))

    j_eng = jax_engine.ServingEngine(j_model, params, table=JaxBucketTable(**grid))
    t_eng = ServingEngine(t_model, table=BucketTable(**grid), device="cpu")
    j_reqs = [j_eng.submit(p, _jax_config(c)) for p, (_, c) in zip(prompts, script)]
    t_reqs = [t_eng.submit(p, c) for p, (_, c) in zip(prompts, script)]
    assert j_eng.run_until_idle() == t_eng.run_until_idle() == 4
    for j_req, t_req in zip(j_reqs, t_reqs):
        assert t_req.status == j_req.status == "ok"
        np.testing.assert_array_equal(t_req.result, np.asarray(j_req.result))
    assert t_eng.stats()["batches"] == j_eng.stats()["batches"] == 2


def test_engine_serve_matches_per_request_generate(pair):
    # prompts no shorter than num_latents: bucketing is token-exact
    _, _, t_model = pair
    rng = np.random.default_rng(8)
    cfg = GenerationConfig(max_new_tokens=6, num_latents=3)
    prompts = [rng.integers(1, 64, (n,)).astype(np.int32) for n in (3, 7, 5)]
    eng = ServingEngine(t_model, cfg, table=BucketTable((4, 8), (1, 2, 4)), device="cpu")
    served = eng.serve(prompts)
    for p, row in zip(prompts, served):
        alone = generate(t_model, p[None], cfg, device="cpu")[0].numpy()
        np.testing.assert_array_equal(row, alone)
    stats = eng.stats()
    assert stats["completed"] == stats["serving_requests_completed_total"] == 3
    assert stats["tokens_generated"] == 18 and stats["ttft_ms"]["p50"] is not None


class _FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_engine_queue_deadline_cancel_drain(pair):
    _, _, t_model = pair
    clock = _FakeClock()
    cfg = GenerationConfig(max_new_tokens=2, num_latents=2)
    eng = ServingEngine(t_model, cfg, table=BucketTable((8,), (1, 2)), max_queue=3,
                        clock=clock, device="cpu")
    assert HEALTH_KEYS <= set(eng.health())
    late = eng.submit([1, 2, 3], deadline_s=1.0)
    keep = eng.submit([4, 5, 6])
    gone = eng.submit([7, 8, 9])
    with pytest.raises(QueueFull):
        eng.submit([1, 2])
    assert not eng.health()["ready"] and eng.health()["shed"] == 1
    with pytest.raises(ValueError):
        eng.submit([])
    with pytest.raises(ValueError):
        eng.submit(list(range(1, 10)))  # longer than the largest bucket
    assert eng.cancel(gone.request_id) and gone.status == "cancelled"
    clock.t = 2.0
    assert eng.drain() == 2
    assert late.status == "timed_out" and keep.status == "ok" and keep.result.shape == (2,)
    with pytest.raises(RuntimeError):
        eng.submit([1, 2, 3])
    health = eng.health()
    assert health["completed"] == health["timed_out"] == health["cancelled"] == 1
    assert not health["accepting"] and health["queue_depth"] == 0
    assert eng.warmup(GenerationConfig(max_new_tokens=1, num_latents=2)) == 4


def test_unported_generation_modes_raise(pair):
    _, _, t_model = pair
    ids = np.ones((1, 4), np.int32)
    with pytest.raises(NotImplementedError):
        generate(t_model, ids, GenerationConfig(num_beams=2), device="cpu")
    with pytest.raises(NotImplementedError):
        generate(t_model, ids, GenerationConfig(sampling=SamplingConfig(do_sample=True)),
                 device="cpu")
    with pytest.raises(ValueError):
        generate(t_model, ids, GenerationConfig(), decode_strategy="fastest", device="cpu")
    with pytest.raises(ValueError):
        generate(t_model, torch.ones((1, 13), dtype=torch.long), GenerationConfig(), device="cpu")
