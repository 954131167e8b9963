"""The port's pretrained dirs, ``pipeline_from_pretrained`` and
``TextSamplingCallback`` against the JAX package, on the CPU, over the byte
vocabulary's tiny model of ``tests/test_torch_port_beam.py`` (weights made
by JAX and carried over).

- ``save_pretrained`` -> ``load_pretrained`` / ``load_config`` /
  ``load_subtree`` round trip, and ``load_pretrained`` of a trainer
  checkpoint dir (and its ``best`` alias);
- ``pipeline_from_pretrained("text-generation", ...)`` gives the direct
  pipeline's text and JAX's ``pipeline_from_pretrained`` text on the same
  weights, with fp32 weights and with ``params_dtype=bfloat16`` (both
  packages store the same bf16-rounded weights and compute in fp32, so the
  greedy text is equal);
- ``TextSamplingCallback`` with ``top_k=1`` logs JAX's greedy text.
"""
import importlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perceiver_io_tpu.data.text.tokenizers import ByteTokenizer as JaxByteTokenizer
from perceiver_io_tpu.models.text.clm import CausalLanguageModel as JaxCLM
from perceiver_io_tpu.models.text.clm import CausalLanguageModelConfig as JaxConfig
from perceiver_io_tpu.training import checkpoint as jax_checkpoint
from perceiver_io_tpu.training.callbacks import TextSamplingCallback as JaxTextSamplingCallback
from perceiver_io_tpu_torch.convert.from_jax import load_jax_params
from perceiver_io_tpu_torch.data.text import ByteTokenizer
from perceiver_io_tpu_torch.inference.pipelines import (
    TextGenerationPipeline, cast_float_params, pipeline, pipeline_from_pretrained,
)
from perceiver_io_tpu_torch.models.text.clm import CausalLanguageModel, CausalLanguageModelConfig
from perceiver_io_tpu_torch.training import (
    BestCheckpointManager, TextSamplingCallback, load_config, load_pretrained, load_subtree, save_pretrained,
)

jax_pipelines = importlib.import_module("perceiver_io_tpu.inference.pipelines")

BYTE_KW = dict(vocab_size=262, max_seq_len=32, max_latents=8, num_channels=16, num_heads=2,
               num_self_attention_layers=1, init_scale=0.5)
PROMPTS = ["Perceiver AR", "a longer prompt here", "short one"]
CALL = dict(max_new_tokens=8, num_latents=8)


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
def byte_pair():
    n = BYTE_KW["max_seq_len"]
    j_model = JaxCLM(config=JaxConfig(**BYTE_KW))
    params = jax.jit(j_model.init, static_argnames="prefix_len")(
        jax.random.PRNGKey(1), jnp.zeros((1, n), jnp.int32), prefix_len=n // 2)["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    config = CausalLanguageModelConfig(**BYTE_KW)
    return j_model, params, config, load_jax_params(CausalLanguageModel(config, device="cpu"), params)


def test_pretrained_round_trip(tmp_path, byte_pair):
    _, _, config, model = byte_pair
    save_pretrained(str(tmp_path / "m"), model, config, extra={"note": "x"})
    assert json.load(open(tmp_path / "m" / "config.json"))["note"] == "x"
    state, loaded = load_pretrained(str(tmp_path / "m"))
    assert loaded == config == load_config(str(tmp_path / "m"))
    assert state.keys() == model.state_dict().keys()
    assert all(torch.equal(state[k], v) for k, v in model.state_dict().items())
    sub = load_subtree(str(tmp_path / "m"), "perceiver_ar/cross_attention")
    fresh = CausalLanguageModel(config, device="cpu", seed=9)
    fresh.perceiver_ar.cross_attention.load_state_dict(sub, strict=True)
    for k, v in fresh.perceiver_ar.cross_attention.state_dict().items():
        assert torch.equal(v, model.perceiver_ar.cross_attention.state_dict()[k])
    with pytest.raises(KeyError):
        load_subtree(str(tmp_path / "m"), "perceiver_ar/no_such_module")

    best = BestCheckpointManager(str(tmp_path / "run" / "checkpoints"), max_to_keep=2)
    best.save(3, fresh, config, 2.0)
    best.save(5, model, config, 1.0)
    for path in ("checkpoints", "checkpoints/best"):  # the best step: 5, the model
        state, loaded = load_pretrained(str(tmp_path / "run" / path))
        assert loaded == config and all(torch.equal(state[k], v) for k, v in model.state_dict().items())


@pytest.mark.parametrize("params_dtype", [None, "bfloat16"])
def test_pipeline_from_pretrained_matches_direct_and_jax(tmp_path, byte_pair, params_dtype):
    j_model, params, config, model = byte_pair
    save_pretrained(str(tmp_path / "port"), model, config)
    jax_checkpoint.save_pretrained(str(tmp_path / "jax"), params, JaxConfig(**BYTE_KW))
    j_pipe = jax_pipelines.pipeline_from_pretrained(
        "text-generation", str(tmp_path / "jax"), JaxByteTokenizer(),
        params_dtype=None if params_dtype is None else jnp.bfloat16)
    pipe = pipeline_from_pretrained("text-generation", str(tmp_path / "port"), ByteTokenizer(),
                                    params_dtype=None if params_dtype is None else torch.bfloat16,
                                    device="cpu")
    assert isinstance(pipe, TextGenerationPipeline)
    got = pipe(PROMPTS, **CALL)
    assert got == j_pipe(PROMPTS, **CALL)
    weights = {p.dtype for p in pipe.model.parameters()}
    if params_dtype is None:
        assert weights == {torch.float32}
        assert got == pipeline("text-generation", model, ByteTokenizer(), device="cpu")(PROMPTS, **CALL)
    else:
        assert weights == {torch.bfloat16}
        direct = cast_float_params(load_jax_params(CausalLanguageModel(config, device="cpu"), params),
                                   torch.bfloat16)
        assert got == pipeline("text-generation", direct, ByteTokenizer(), device="cpu")(PROMPTS, **CALL)


class _Logs:
    """The trainer surface a callback uses: ``log_text``."""

    def __init__(self):
        self.texts = []

    def log_text(self, step, tag, text):
        self.texts.append((step, tag, text))


def test_text_sampling_callback_logs_jax_greedy_text(byte_pair):
    j_model, params, _, model = byte_pair
    kw = dict(prompt="Perceiver", max_new_tokens=8, num_latents=8, top_k=1)
    j_logs, logs = _Logs(), _Logs()
    JaxTextSamplingCallback(j_model, JaxByteTokenizer(), **kw)(j_logs, type("S", (), {"params": params}), 4, {})
    TextSamplingCallback(model, ByteTokenizer(), **kw)(logs, None, 4, {})
    assert logs.texts == j_logs.texts and logs.texts[0][1] == "samples/generated"
    assert logs.texts[0][2].startswith("Perceiver")
