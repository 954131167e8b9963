"""``PERCEIVER_FUSED_QKV`` in the port against the JAX package, on the CPU
(mirrors ``tests/test_fused_qkv.py``).

- **CLM**: logits, loss and every gradient with the switch on equal the
  unfused port's and JAX's fused ``apply`` (``jax.grad``), at JAX's
  tolerances (logits atol/rtol 1e-5, loss rtol 1e-6, gradients atol 1e-5
  rtol 1e-4); the forward runs 5 fewer products (q, k and v in one per
  self-attention layer, k and v in one at the cross-attention).
- **MLM**: the encoder's and decoder's cross-attention k/v and the
  latents' q/k/v, fused, against both at 1e-5.
- The ``state_dict`` is the same with the switch on; the switch is read at
  every call, as JAX's un-jitted ``apply`` reads it.
- Greedy ``generate()`` (prefill and decode through ``project_kv``) gives
  the same tokens on and off.
- The slot engine flushes its prefix index when the switch flips between
  lookups, as JAX's does.

The tensor-parallel fused step (``model=2``) is a case of
``tests/test_torch_port_parallel.py``'s world of two.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from perceiver_io_tpu.models.core import modules as jax_modules
from perceiver_io_tpu.models.core.config import PerceiverIOConfig as JaxIOConfig
from perceiver_io_tpu.models.text.clm import CausalLanguageModel as JaxCLM
from perceiver_io_tpu.models.text.clm import CausalLanguageModelConfig as JaxCLMConfig
from perceiver_io_tpu.models.text.common import TextEncoderConfig as JaxEncoderConfig
from perceiver_io_tpu.models.text.mlm import MaskedLanguageModel as JaxMLM
from perceiver_io_tpu.models.text.mlm import TextDecoderConfig as JaxDecoderConfig
from perceiver_io_tpu_torch.convert.from_jax import load_jax_params, state_dict_from_jax
from perceiver_io_tpu_torch.inference import generate as gen
from perceiver_io_tpu_torch.models.core import modules
from perceiver_io_tpu_torch.models.core.config import PerceiverIOConfig
from perceiver_io_tpu_torch.models.text.clm import CausalLanguageModel, CausalLanguageModelConfig
from perceiver_io_tpu_torch.models.text.common import TextEncoderConfig
from perceiver_io_tpu_torch.models.text.mlm import MaskedLanguageModel, TextDecoderConfig

ENV = "PERCEIVER_FUSED_QKV"
TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)
# JAX's test's models
CLM_KW = dict(vocab_size=32, max_seq_len=24, max_latents=8, num_channels=32, num_heads=4,
              num_self_attention_layers=2, cross_attention_dropout=0.0)
PREFIX = CLM_KW["max_seq_len"] - CLM_KW["max_latents"]
MLM_ENC = dict(vocab_size=32, max_seq_len=24, num_input_channels=32, num_cross_attention_heads=2,
               num_self_attention_heads=4, num_self_attention_layers_per_block=2)
MLM_DEC = dict(vocab_size=32, max_seq_len=24)
MLM_LAT = dict(num_latents=4, num_latent_channels=32)
GEMMS = {torch.ops.aten.mm.default, torch.ops.aten.addmm.default, torch.ops.aten.bmm.default}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    # tiny shapes: with the suite's workers sharing the cores, one intra-op
    # thread a worker is several times faster than the default
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def fused_env():
    """Every test starts with the switch unset and leaves it as it was."""
    old = os.environ.pop(ENV, None)
    yield
    if old is None:
        os.environ.pop(ENV, None)
    else:
        os.environ[ENV] = old


def _toggle(value: str) -> None:
    os.environ[ENV] = value


class _CountGemms(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.calls = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.calls += func in GEMMS
        return func(*args, **(kwargs or {}))


def _seeded(j_model, *args, seed=0):
    shapes = jax.eval_shape(lambda: j_model.init(jax.random.PRNGKey(0), *args))["params"]
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(lambda s: (rng.standard_normal(s.shape) * 0.1).astype(np.float32), shapes)


@pytest.fixture(scope="module")
def clm_pair():
    j_model = JaxCLM(JaxCLMConfig(**CLM_KW))
    params = _seeded(j_model, jnp.zeros((1, CLM_KW["max_seq_len"]), jnp.int32), PREFIX)
    t_model = CausalLanguageModel(CausalLanguageModelConfig(**CLM_KW), device="cpu")
    load_jax_params(t_model, params)
    return j_model, params, t_model.eval()


def _port_loss(model, ids):
    """JAX's test's loss: the mean negative log-softmax of the logits."""
    model.zero_grad(set_to_none=True)
    logits = model(ids, PREFIX)
    loss = -torch.log_softmax(logits, dim=-1).mean()
    loss.backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    return logits.detach(), loss.detach(), grads


def test_clm_forward_and_grads_fused_match_unfused_and_jax(clm_pair):
    j_model, params, t_model = clm_pair
    ids_np = np.random.default_rng(0).integers(0, 32, (2, CLM_KW["max_seq_len"]))
    ids = torch.from_numpy(ids_np)
    logits0, loss0, grads0 = _port_loss(t_model, ids)
    _toggle("1")
    with _CountGemms() as fused_gemms:
        logits1, loss1, grads1 = _port_loss(t_model, ids)

    def loss(p):  # traced after the toggle: JAX's fused path
        logits = j_model.apply({"params": p}, jnp.asarray(ids_np, jnp.int32), PREFIX)
        return -jax.nn.log_softmax(logits, axis=-1).mean(), logits

    (j_loss, j_logits), j_grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    j_grads = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, j_grads))
    np.testing.assert_allclose(logits1.numpy(), logits0.numpy(), **TOL)
    np.testing.assert_allclose(logits1.numpy(), np.asarray(j_logits), **TOL)
    np.testing.assert_allclose(float(loss1), float(loss0), rtol=1e-6)
    np.testing.assert_allclose(float(loss1), float(j_loss), rtol=1e-6)
    assert set(grads1) == set(grads0) == set(j_grads)
    for name, g in grads1.items():
        np.testing.assert_allclose(g.numpy(), grads0[name].numpy(), err_msg=name, **GRAD_TOL)
        np.testing.assert_allclose(g.numpy(), j_grads[name].numpy(), err_msg=name, **GRAD_TOL)
    # the forward's products: two self-attention layers q/k/v 3 -> 1, the
    # cross-attention k/v 2 -> 1 (its q reads only the latents)
    os.environ.pop(ENV)
    with torch.no_grad():
        with _CountGemms() as off:
            t_model(ids, PREFIX)
        _toggle("1")
        with _CountGemms() as on:
            t_model(ids, PREFIX)
    assert off.calls - on.calls == 2 * 2 + 1, (off.calls, on.calls)
    assert fused_gemms.calls > on.calls  # the backward's products were counted too


def test_mlm_forward_fused_matches_unfused_and_jax():
    cfg = PerceiverIOConfig(encoder=TextEncoderConfig(**MLM_ENC), decoder=TextDecoderConfig(**MLM_DEC), **MLM_LAT)
    j_model = JaxMLM(JaxIOConfig(encoder=JaxEncoderConfig(**MLM_ENC), decoder=JaxDecoderConfig(**MLM_DEC),
                                 **MLM_LAT))
    params = _seeded(j_model, jnp.zeros((1, 24), jnp.int32), seed=1)
    t_model = MaskedLanguageModel(cfg, device="cpu")
    load_jax_params(t_model, params)
    ids_np = np.random.default_rng(1).integers(0, 32, (2, 24))
    ids = torch.from_numpy(ids_np)
    with torch.no_grad(), _CountGemms() as off:
        out0 = t_model(ids)
    _toggle("1")
    with torch.no_grad(), _CountGemms() as on:
        out1 = t_model(ids)
    # the encoder's and the decoder's cross-attention k/v 2 -> 1, two
    # self-attention layers q/k/v 3 -> 1
    assert off.calls - on.calls == 1 + 1 + 2 * 2, (off.calls, on.calls)
    j_out = jax.jit(lambda p, x: j_model.apply({"params": p}, x))(params, jnp.asarray(ids_np, jnp.int32))
    np.testing.assert_allclose(out1.numpy(), out0.numpy(), **TOL)
    np.testing.assert_allclose(out1.numpy(), np.asarray(j_out), **TOL)


def test_switch_is_read_per_call_and_keeps_the_state_dict(clm_pair):
    for value in (None, "0", "1", "true", ""):
        if value is None:
            os.environ.pop(ENV, None)
        else:
            _toggle(value)
        assert modules.fused_qkv_enabled() is jax_modules.fused_qkv_enabled() is (value == "1"), value
    _, _, t_model = clm_pair
    _toggle("1")
    fused = CausalLanguageModel(CausalLanguageModelConfig(**CLM_KW), device="cpu", seed=1)
    assert {k: tuple(v.shape) for k, v in fused.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in t_model.state_dict().items()}


@pytest.mark.parametrize("pads", [None, (0, 3)])
def test_greedy_generate_tokens_equal_on_and_off(clm_pair, pads):
    _, _, t_model = clm_pair
    ids = torch.from_numpy(np.random.default_rng(2).integers(1, 32, (2, 12)))
    cfg = gen.GenerationConfig(max_new_tokens=14, num_latents=4)  # growth, then boundary steps
    kw = dict(device="cpu", prompt_pad_count=None if pads is None else torch.tensor(pads))
    off = gen.generate(t_model, ids, cfg, **kw)
    _toggle("1")
    with _CountGemms() as counted:
        on = gen.generate(t_model, ids, cfg, **kw)
    assert torch.equal(on, off)
    assert counted.calls > 0


def test_slot_engine_flushes_its_prefix_index_when_the_switch_flips(clm_pair):
    """A hit before the flip, a miss after it (the index flushed at the
    lookup), each output equal to ``generate()`` under its setting."""
    from perceiver_io_tpu_torch.serving.buckets import BucketTable
    from perceiver_io_tpu_torch.serving.slots import SlotServingEngine

    _, _, t_model = clm_pair
    cfg = gen.GenerationConfig(max_new_tokens=4, num_latents=2)
    engine = SlotServingEngine(t_model, cfg, BucketTable(prompt_lens=(16,), batch_sizes=(1,)), slots=2,
                               kv_layout="paged", kv_block_size=4, prefix_cache="on", device="cpu")
    prompt = np.random.default_rng(3).integers(1, 32, 14)
    ref = gen.generate(t_model, torch.from_numpy(prompt)[None], cfg, device="cpu")[0].numpy()
    for _ in range(2):
        np.testing.assert_array_equal(engine.serve([prompt])[0], ref)
    cached = engine._prefix_index.cached_blocks
    assert cached == 3 and engine.stats()["prefix_cache"]["hits"] == 1
    _toggle("1")
    np.testing.assert_array_equal(engine.serve([prompt])[0], ref)
    stats = engine.stats()
    assert stats["prefix_cache"]["hits"] == 1 and stats["prefix_cache"]["misses"] == 2
    assert engine._pool.frees_by_cause["shared"] >= cached and engine._pool.leaked() == 0
