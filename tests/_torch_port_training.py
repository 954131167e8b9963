"""Shared pieces of the port's training parity tests: one tiny CLM (vocab
32, seq 16, 8 latents, 32 channels, 4 heads, 2 layers) built in both
packages from one set of JAX weights, seeded numpy batches, and the
recorder/replayer that carries JAX's dropout draws over to the port.

JAX draws every dropout mask with ``jax.random.bernoulli``; :class:`Recorder`
wraps it and keeps the masks in call order.
The port draws every mask through ``ops.attention.dropout_keep``;
:class:`Replay` stands in for it and hands out the recorded masks. A mask is
keyed by the generator's state at the draw, so a checkpointed layer's
recompute (which rewinds the generator) gets the same masks again.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from perceiver_io_tpu.models.text.clm import CausalLanguageModel as JaxCLM
from perceiver_io_tpu.models.text.clm import CausalLanguageModelConfig as JaxConfig
from perceiver_io_tpu_torch.convert.from_jax import load_jax_params, state_dict_from_jax
from perceiver_io_tpu_torch.models.text.clm import CausalLanguageModel, CausalLanguageModelConfig

VOCAB, SEQ, LATENTS, CH, HEADS = 32, 16, 8, 32, 4
PREFIX = SEQ - LATENTS
LOSS_RTOL = 1e-5
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)


def kw(**rates):
    base = dict(vocab_size=VOCAB, max_seq_len=SEQ, max_latents=LATENTS, num_channels=CH,
                num_heads=HEADS, num_self_attention_layers=2, cross_attention_dropout=0.0)
    base.update(rates)
    return base


@functools.lru_cache(maxsize=1)
def jax_params():
    init = jax.jit(JaxCLM(JaxConfig(**kw())).init, static_argnums=2)
    params = init(jax.random.PRNGKey(0), jnp.zeros((1, SEQ), jnp.int32), PREFIX)["params"]
    return jax.tree_util.tree_map(np.asarray, params)


def pair(**rates):
    """JAX model, its params (numpy; rates add none) and the port model on
    the CPU with those params."""
    j_model = JaxCLM(JaxConfig(**kw(**rates)))
    t_model = CausalLanguageModel(CausalLanguageModelConfig(**kw(**rates)), device="cpu")
    load_jax_params(t_model, jax_params())
    return j_model, jax_params(), t_model


def batches(n, batch_size=8, seed=0, pads=None, vocab=VOCAB, seq=SEQ):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = rng.integers(0, vocab, size=(batch_size, seq + 1), dtype=np.int32)
        batch = {"input_ids": ids[:, :-1], "labels": ids[:, 1:]}
        if pads is not None:
            batch["pad_mask"] = np.arange(seq)[None, :] < np.asarray(pads)[:, None]
        out.append(batch)
    return out


def to_torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def assert_grads(t_model, j_grads, **tol):
    expected = state_dict_from_jax(j_grads)
    for name, p in t_model.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name
        np.testing.assert_allclose(p.grad.numpy(), expected[name].numpy(), err_msg=name, **tol)


def assert_params(t_model, j_params, **tol):
    expected = state_dict_from_jax(jax.device_get(j_params))
    for name, p in t_model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), expected[name].numpy(), err_msg=name, **tol)


class Recorder:
    """``jax.random.bernoulli`` that keeps every mask it returns, in call
    order: at once when eager, through an ordered ``jax.debug.callback``
    under ``jax.jit`` (read them after ``jax.effects_barrier()``)."""

    def __init__(self):
        self.masks = []
        #: off: draw without keeping (e.g. while tracing a remat model)
        self.active = True
        self._bernoulli = jax.random.bernoulli

    def _keep(self, mask):
        self.masks.append(np.array(mask))

    def __call__(self, key, p=0.5, shape=None, *args, **kwargs):
        out = self._bernoulli(key, p, shape, *args, **kwargs)
        if not self.active:
            return out
        if isinstance(out, jax.core.Tracer):
            jax.debug.callback(self._keep, out, ordered=True)
        else:
            self._keep(out)
        return out


class Replay:
    """``dropout_keep`` that returns recorded masks in draw order. The
    generator's state at a draw picks the mask (a new state takes the next
    one), and the draw advances the generator, so a rewound generator
    replays the same masks."""

    def __init__(self, masks):
        self.masks = list(masks)
        self.by_state = {}

    def __call__(self, shape, rate, generator, device):
        key = bytes(generator.get_state().numpy())
        if key not in self.by_state:
            self.by_state[key] = len(self.by_state)
        mask = self.masks[self.by_state[key]]
        assert tuple(mask.shape) == tuple(shape), (mask.shape, shape)
        torch.rand(1, generator=generator, device=device)
        return torch.from_numpy(mask).to(device)

    @property
    def used(self) -> int:
        return len(self.by_state)
