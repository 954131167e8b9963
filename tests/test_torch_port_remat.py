"""The port's activation checkpointing and offloading, on the CPU.

- With prefix, attention and residual dropout on and two microbatches
  drawing from one generator, loss and gradients under
  ``activation_checkpointing`` (and with ``activation_offloading``) equal
  the plain model's exactly, and the generator ends where the plain run
  leaves it: the recompute replays the layer's masks from the generator
  state taken before the layer, then puts the generator back.
- Offloading hands exactly the layer inputs to the host hook (the
  cross-attention layer's latents, kept prefix and pad mask, each stack
  layer's input), counted in ``modules.offload_counts``.
- Both equal JAX's ``nn.remat`` model on the same weights and masks (JAX's
  draws replayed as in ``tests/test_torch_port_dropout.py``; loss rtol
  1e-5, gradients atol 1e-5 / rtol 1e-4).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_port_training import (
    CH, GRAD_TOL, LATENTS, LOSS_RTOL, PREFIX, Recorder, Replay, assert_grads, batches, jax_params, kw,
    to_torch,
)
from perceiver_io_tpu.models.text.clm import CausalLanguageModel as JaxCLM
from perceiver_io_tpu.models.text.clm import CausalLanguageModelConfig as JaxConfig
from perceiver_io_tpu.training import tasks as jax_tasks
from perceiver_io_tpu_torch.convert.from_jax import load_jax_params
from perceiver_io_tpu_torch.models.core import modules
from perceiver_io_tpu_torch.models.text.clm import CausalLanguageModel, CausalLanguageModelConfig
from perceiver_io_tpu_torch.ops import attention
from perceiver_io_tpu_torch.parallel import TrainState, make_gradient_step
from perceiver_io_tpu_torch.training import clm_loss_fn, make_optimizer

RATES = dict(cross_attention_dropout=0.5, post_attention_dropout=0.2, residual_dropout=0.1)
MODES = {"plain": {}, "remat": dict(activation_checkpointing=True),
         "remat_offload": dict(activation_checkpointing=True, activation_offloading=True)}
PADS = [0, 2, 5, 7, 0, 1, 3, 6]


def _model(mode, **rates):
    model = CausalLanguageModel(CausalLanguageModelConfig(**kw(**rates, **MODES[mode])), device="cpu")
    return load_jax_params(model, jax_params())


def _grads(mode, generator, batch, accum=2):
    model = _model(mode, **RATES)
    step = make_gradient_step(clm_loss_fn(model, LATENTS), grad_accum_steps=accum, device="cpu")
    metrics = step(TrainState.create(model, make_optimizer(1e-3)), batch, generator)
    return metrics["loss"], {n: p.grad.clone() for n, p in model.named_parameters()}


@pytest.mark.parametrize("mode", ["remat", "remat_offload"])
def test_checkpointing_equals_plain_under_dropout(mode):
    batch = batches(1, pads=PADS)[0]
    gens = {m: torch.Generator().manual_seed(11) for m in ("plain", mode)}
    modules.reset_offload_counts()
    ref_loss, ref = _grads("plain", gens["plain"], batch)
    assert modules.offload_counts == {"tensors": 0, "bytes": 0}
    loss, grads = _grads(mode, gens[mode], batch)
    assert torch.equal(loss, ref_loss)
    for name, g in grads.items():
        assert torch.equal(g, ref[name]), name
    assert torch.equal(gens[mode].get_state(), gens["plain"].get_state())
    if mode == "remat":
        assert modules.offload_counts == {"tensors": 0, "bytes": 0}
        return
    # per microbatch of 4 rows: the cross layer's latents (4, 8, 32) fp32, kept
    # prefix (4, 4, 32) fp32 and pad mask (4, 4 + 8) bool; two stack inputs (4, 8, 32)
    keep = PREFIX - int(PREFIX * 0.5)
    per_micro = [4 * LATENTS * CH * 4, 4 * keep * CH * 4, 4 * (keep + LATENTS), 2 * 4 * LATENTS * CH * 4]
    assert modules.offload_counts == {"tensors": 2 * 5, "bytes": 2 * sum(per_micro)}


def test_checkpointing_off_without_grad_and_offload_alone_is_plain():
    """No grad (validation, generation): layers run as they are, nothing is
    offloaded. ``activation_offloading`` without checkpointing does nothing,
    as in JAX."""
    ids = to_torch(batches(1, batch_size=2)[0])["input_ids"]
    modules.reset_offload_counts()
    plain = _model("plain")
    with torch.no_grad():
        out = _model("remat_offload")(ids, PREFIX)
    np.testing.assert_array_equal(out.numpy(), plain(ids, PREFIX).detach().numpy())
    alone = CausalLanguageModel(CausalLanguageModelConfig(**kw(activation_offloading=True)), device="cpu")
    load_jax_params(alone, jax_params())
    alone(ids, PREFIX).sum().backward()
    assert modules.offload_counts == {"tensors": 0, "bytes": 0}


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
def jax_remat_run():
    """JAX's remat model under dropout: its loss and gradients, and the masks
    of the same keys drawn by the plain model's forward (remat keeps the
    module paths, so the keys and masks are the same)."""
    batch = batches(1, batch_size=4, pads=[0, 2, 5, 7])[0]
    noise = np.random.default_rng(5).random((4, PREFIX)).astype(np.float32)
    plain, remat = JaxCLM(JaxConfig(**kw(**RATES))), JaxCLM(JaxConfig(**kw(**RATES, **MODES["remat"])))
    recorder = Recorder()
    key = jax.random.PRNGKey(8)
    patch = pytest.MonkeyPatch()
    patch.setattr(jax.random, "bernoulli", recorder)
    patch.setattr(jax.random, "uniform", lambda key, shape, *a, **k: jnp.asarray(noise))
    try:
        @jax.jit
        def run(params, batch):
            d, p = jax.random.split(key)
            recorder.active = True
            plain.apply({"params": params}, batch["input_ids"], PREFIX, pad_mask=batch["pad_mask"],
                        deterministic=False, rngs={"dropout": d, "prefix": p})
            recorder.active = False
            return jax.value_and_grad(jax_tasks.clm_loss_fn(remat, LATENTS), has_aux=True)(params, batch, key)

        (loss, _), grads = run(jax_params(), batch)
        jax.effects_barrier()
    finally:
        patch.undo()
    return batch, noise, recorder.masks, float(loss), grads


@pytest.mark.parametrize("mode", ["remat", "remat_offload"])
def test_checkpointing_matches_jax_remat(monkeypatch, jax_remat_run, mode):
    batch, noise, masks, j_loss, j_grads = jax_remat_run
    assert len(masks) == 9  # 3 layers x (attention, attention branch, MLP branch)
    replay = Replay(masks)
    monkeypatch.setattr(attention, "dropout_keep", replay)
    monkeypatch.setattr(modules, "prefix_noise", lambda b, n, g, device: torch.from_numpy(noise))
    model = _model(mode, **RATES)
    loss, _ = clm_loss_fn(model, LATENTS)(model, to_torch(batch), torch.Generator().manual_seed(0))
    loss.backward()
    assert replay.used == 9  # the recompute found its masks by the generator's state
    np.testing.assert_allclose(loss.item(), j_loss, rtol=LOSS_RTOL)
    assert_grads(model, j_grads, **GRAD_TOL)
