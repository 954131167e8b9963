"""The port's beam search, byte tokenizer and text-generation pipeline
against the JAX package, on the CPU.

- beam search token-identical to JAX's ``beam.py`` on the same weights: the
  three plans of ``tests/test_generate.py`` ``TestBeamParity`` (latent
  growth only; across prefix growth and the slide; starting at the maximum
  latent count), the EOS pad tail, ``length_penalty``, the repetition
  penalty and ragged pads; and the port's logits through JAX's exact HF
  bookkeeping oracle (``tests/_eager_beam.py``) equal to the port's search,
  with zero tolerance; ``num_beams=1`` equals greedy ``generate()``;
- the port's ``ByteTokenizer`` copy equal to JAX's;
- ``TextGenerationPipeline`` with the byte tokenizer: JAX's text for greedy,
  bucketed and beam calls, the warning under beam, the sampling knobs left
  greedy (``do_sample`` is never set), and the ``pipeline`` dispatch.
"""
import dataclasses
import importlib
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perceiver_io_tpu.data.text.tokenizers import ByteTokenizer as JaxByteTokenizer
from perceiver_io_tpu.models.text.clm import CausalLanguageModel as JaxCLM
from perceiver_io_tpu.models.text.clm import CausalLanguageModelConfig as JaxConfig
from perceiver_io_tpu.serving import BucketTable as JaxBucketTable
from perceiver_io_tpu_torch.convert.from_jax import load_jax_params
from perceiver_io_tpu_torch.data.text import ByteTokenizer
from perceiver_io_tpu_torch.inference import generate as port_gen
from perceiver_io_tpu_torch.inference.beam import beam_search
from perceiver_io_tpu_torch.inference.generate import GenerationConfig, generate
from perceiver_io_tpu_torch.inference.pipelines import OpticalFlowPipeline, TextGenerationPipeline, pipeline
from perceiver_io_tpu_torch.inference.samplers import SamplingConfig
from perceiver_io_tpu_torch.models.text.clm import CausalLanguageModel, CausalLanguageModelConfig
from perceiver_io_tpu_torch.serving.buckets import BucketTable
from tests._eager_beam import eager_beam_search

jax_gen = importlib.import_module("perceiver_io_tpu.inference.generate")
jax_samplers = importlib.import_module("perceiver_io_tpu.inference.samplers")
jax_pipelines = importlib.import_module("perceiver_io_tpu.inference.pipelines")

# the model of tests/test_generate.py
KW = dict(vocab_size=32, max_seq_len=16, max_latents=8, num_channels=16, num_heads=2,
          num_self_attention_layers=2, init_scale=0.1)
# the byte vocabulary's model for the pipeline
BYTE_KW = dict(vocab_size=262, max_seq_len=32, max_latents=8, num_channels=16, num_heads=2,
               num_self_attention_layers=1, init_scale=0.5)


def _pair(kw):
    n = kw["max_seq_len"]
    j_model = JaxCLM(config=JaxConfig(**kw))
    params = jax.jit(j_model.init, static_argnames="prefix_len")(
        jax.random.PRNGKey(1), jnp.zeros((1, n), jnp.int32), prefix_len=n // 2
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
    return _pair(KW)


@pytest.fixture(scope="module")
def byte_pair():
    return _pair(BYTE_KW)


def _jax_config(cfg: GenerationConfig):
    s = cfg.sampling
    return jax_gen.GenerationConfig(
        max_new_tokens=cfg.max_new_tokens, num_latents=cfg.num_latents,
        eos_token_id=cfg.eos_token_id, pad_token_id=cfg.pad_token_id,
        min_new_tokens=cfg.min_new_tokens, num_beams=cfg.num_beams,
        length_penalty=cfg.length_penalty,
        sampling=jax_samplers.SamplingConfig(repetition_penalty=s.repetition_penalty),
    )


# (prompt_len, num_latents, new_tokens, num_beams, extra config, pads)
BEAM_CASES = {
    "latent_growth": (4, 2, 4, 3, {}, None),
    "all_phases": (4, 2, 14, 3, {}, None),
    "max_latents": (12, 8, 10, 2, {}, None),
    "eos": (4, 2, 10, 3, dict(eos_token_id=5, min_new_tokens=0), None),
    "eos_length_penalty_2": (4, 2, 10, 3, dict(eos_token_id=5, min_new_tokens=0,
                                               length_penalty=2.0), None),
    "eos_length_penalty_half": (4, 2, 10, 4, dict(eos_token_id=5, min_new_tokens=0,
                                                  length_penalty=0.5), None),
    "repetition_penalty": (6, 3, 8, 3, dict(sampling=SamplingConfig(repetition_penalty=1.5)), None),
    "ragged_pads": (8, 3, 8, 3, dict(eos_token_id=5, min_new_tokens=2), (3, 0)),
}


def _beam_case(case):
    prompt_len, num_latents, new_tokens, num_beams, extra, pads = BEAM_CASES[case]
    ids = np.random.default_rng(4).integers(1, KW["vocab_size"], (2, prompt_len)).astype(np.int32)
    cfg = dataclasses.replace(
        GenerationConfig(max_new_tokens=new_tokens, num_latents=num_latents, num_beams=num_beams,
                         min_new_tokens=new_tokens), **extra)
    return ids, cfg, None if pads is None else np.asarray(pads, np.int32)


@pytest.mark.parametrize("case", list(BEAM_CASES))
def test_beam_matches_jax(pair, case):
    j_model, params, t_model = pair
    ids, cfg, pads = _beam_case(case)
    expected = np.asarray(jax_gen.generate(
        j_model, params, jnp.asarray(ids), _jax_config(cfg),
        prompt_pad_count=None if pads is None else jnp.asarray(pads)))
    actual = generate(t_model, ids, cfg, prompt_pad_count=pads, device="cpu").numpy()
    np.testing.assert_array_equal(actual, expected)
    if cfg.eos_token_id is not None:
        for row in actual:  # once a hypothesis finishes, its tail is pad
            hits = np.where(row == cfg.eos_token_id)[0]
            if hits.size:
                assert (row[hits[0] + 1:] == cfg.pad_token_id).all()


class _PortLogits:
    """The port's ``_decode_forward`` behind the JAX model's ``apply``, so
    JAX's eager HF bookkeeping oracle runs on the port's logits."""

    def __init__(self, t_model):
        self.t_model = t_model
        self.max_seq_len, self.max_latents = t_model.max_seq_len, t_model.max_latents
        self.config = t_model.config

    def apply(self, variables, window, pad_count, m, method):
        with torch.no_grad():
            logits = port_gen._decode_forward(
                self.t_model, torch.from_numpy(np.array(window)).long(),
                torch.from_numpy(np.array(pad_count)).long(), int(m))
        return jnp.asarray(logits.numpy())


@pytest.mark.parametrize("case", ["latent_growth", "all_phases", "max_latents", "eos",
                                  "eos_length_penalty_2"])
def test_beam_matches_eager_bookkeeping_on_port_logits(pair, case):
    _, _, t_model = pair
    ids, cfg, _ = _beam_case(case)
    want = eager_beam_search(_PortLogits(t_model), None, ids, cfg)
    got = beam_search(t_model, ids, cfg, num_beams=cfg.num_beams,
                      length_penalty=cfg.length_penalty, device="cpu").numpy()
    np.testing.assert_array_equal(got, want)


def test_one_beam_is_greedy(pair):
    _, _, t_model = pair
    ids = np.random.default_rng(6).integers(1, 32, (3, 5)).astype(np.int32)
    cfg = GenerationConfig(max_new_tokens=12, num_latents=2, eos_token_id=9)
    greedy = generate(t_model, ids, cfg, device="cpu").numpy()
    np.testing.assert_array_equal(beam_search(t_model, ids, cfg, num_beams=1, device="cpu").numpy(),
                                  greedy)


def test_beam_refuses_what_generate_refuses(pair):
    _, _, t_model = pair
    cfg = GenerationConfig(num_beams=2, max_new_tokens=2)
    with pytest.raises(ValueError, match="prompt length"):
        generate(t_model, np.ones((1, 17), np.int32), cfg, device="cpu")
    with pytest.raises(ValueError, match="num_latents"):
        generate(t_model, np.ones((1, 4), np.int32), dataclasses.replace(cfg, num_latents=9),
                 device="cpu")


# -- the byte tokenizer ------------------------------------------------------
TEXTS = ["hello world", "  two  spaces\tand a tab", "héllo <mask> wörld", "", "x"]


def test_byte_tokenizer_matches_jax():
    t, j = ByteTokenizer(), JaxByteTokenizer()
    for text in TEXTS:
        for special in (False, True):
            assert t.encode(text, special) == j.encode(text, special)
        ids = t.encode(text, True)
        assert t.decode(ids) == j.decode(ids) and t.decode(ids, False) == j.decode(ids, False)
        assert t.word_ids(ids) == j.word_ids(ids)
    for side in ("left", "right"):
        for kw in (dict(), dict(max_length=6, add_special_tokens=True)):
            got = ByteTokenizer(side).encode_batch(TEXTS, **kw)
            want = JaxByteTokenizer(side).encode_batch(TEXTS, **kw)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
    assert t.batch_decode([[110, 111], [7]]) == j.batch_decode([[110, 111], [7]])
    assert (t.vocab_size, t.pad_token_id, t.eos_token_id, t.mask_token_id) == \
        (j.vocab_size, j.pad_token_id, j.eos_token_id, j.mask_token_id)


# -- the pipeline ------------------------------------------------------------
PROMPTS = ["Perceiver AR", "a longer prompt here", "short one"]
PIPE_CALLS = {
    "greedy": dict(max_new_tokens=8, num_latents=8),
    "beam": dict(max_new_tokens=6, num_latents=8, num_beams=3, length_penalty=0.8),
    "knobs_stay_greedy": dict(max_new_tokens=8, num_latents=8, temperature=0.5, top_k=3,
                              top_p=0.8, seed=3),
    "penalty_min_new": dict(max_new_tokens=8, num_latents=8, repetition_penalty=1.4,
                            min_new_tokens=4, return_full_text=False),
}


@pytest.mark.parametrize("bucketing", [False, True], ids=["direct", "bucketed"])
@pytest.mark.parametrize("call", list(PIPE_CALLS))
def test_pipeline_matches_jax(byte_pair, call, bucketing):
    j_model, params, t_model = byte_pair
    kw = PIPE_CALLS[call]
    table = dict(prompt_lens=(16, 32), batch_sizes=(1, 4))
    j_pipe = jax_pipelines.TextGenerationPipeline(
        j_model, params, JaxByteTokenizer(), bucketing=bucketing,
        bucket_table=JaxBucketTable(**table))
    pipe = pipeline("text-generation", t_model, ByteTokenizer(), bucketing=bucketing,
                    bucket_table=BucketTable(**table), device="cpu")
    assert isinstance(pipe, TextGenerationPipeline)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = j_pipe(PROMPTS, **kw)
        got = pipe(PROMPTS, **kw)
    assert got == want
    if kw.get("return_full_text", True):
        assert all(text.startswith(p) for text, p in zip(got, PROMPTS))
    assert pipe(PROMPTS[0], **kw) == j_pipe(PROMPTS[0], **kw)  # one string in, one out
    served = pipe.serving_stats()
    assert (served is not None) == (bucketing and kw.get("num_beams", 1) == 1)
    if call == "knobs_stay_greedy":  # do_sample is never set: the knobs change nothing
        assert got == pipe(PROMPTS, max_new_tokens=8, num_latents=8)


def test_pipeline_warns_under_beam_and_dispatches(byte_pair):
    _, _, t_model = byte_pair
    pipe = TextGenerationPipeline(t_model, ByteTokenizer(), device="cpu")
    with pytest.warns(UserWarning, match="ignored when num_beams > 1"):
        pipe("hi there", max_new_tokens=2, num_latents=2, num_beams=2, temperature=0.7)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        pipe("hi there", max_new_tokens=2, num_latents=2, num_beams=2)
        pipe("hi there", max_new_tokens=2, num_latents=2, temperature=0.7)
    with pytest.raises(ValueError, match="requires bucketing"):
        pipe.warmup()
    assert isinstance(pipeline("optical-flow", t_model, device="cpu"), OpticalFlowPipeline)  # every task ported
    with pytest.raises(ValueError, match="unknown task"):
        pipeline("translation", t_model)
