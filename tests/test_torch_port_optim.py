"""The port's LAMB and multi-step train step against the JAX package, on
the CPU, over the tiny CLM of ``tests/_torch_port_training.py``.

- LAMB (``make_optimizer(optimizer="lamb")``, the port's own
  ``torch.optim.Optimizer``) over 5 train steps with weight decay, a cosine
  schedule and frozen prefixes equals ``optax.lamb`` through JAX's
  ``make_train_step`` (params rtol 1e-5, atol 1e-6 for entries near 0,
  while the gradients agree at atol 1e-5); the zero-initialised output bias
  exercises the trust ratio of 1 where a norm is 0.
- ``multi_steps=4`` equals four single steps (exactly, with dropout drawn
  from per-step generators) and JAX's ``multi_steps=4`` (AdamW at 1e-3;
  losses rtol 1e-5, params atol 1e-5 / rtol 1e-4); its metrics come back
  stacked.
- A ragged block under ``steps_per_execution=2`` raises JAX's error.
"""
import numpy as np
import optax
import pytest
import torch

from tests._torch_port_training import (
    GRAD_TOL, LATENTS, LOSS_RTOL, SEQ, assert_params, batches, jax_params, pair,
)
from perceiver_io_tpu.parallel import MeshConfig, create_train_state, make_mesh, shard_batch
from perceiver_io_tpu.parallel import make_train_step as jax_make_train_step
from perceiver_io_tpu.training import lrs as jax_lrs
from perceiver_io_tpu.training import tasks as jax_tasks
from perceiver_io_tpu.training.optim import make_optimizer as jax_make_optimizer
from perceiver_io_tpu.training.trainer import Trainer as JaxTrainer
from perceiver_io_tpu.training.trainer import TrainerConfig as JaxTrainerConfig
from perceiver_io_tpu_torch.parallel import TrainState, make_train_step
from perceiver_io_tpu_torch.training import (
    Lamb, Trainer, TrainerConfig, clm_loss_fn, cosine_with_warmup, make_optimizer,
)
from perceiver_io_tpu_torch.training.trainer import step_generator

FROZEN = ("perceiver_ar/input_adapter/pos_embedding", "perceiver_ar/self_attention/layers_1/mlp")


def _jax_state(tx):
    mesh = make_mesh(MeshConfig(data=1))
    state, shardings = create_train_state(lambda: jax_params(), tx, mesh, initial_params=jax_params())
    return mesh, state, shardings


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    # tiny shapes: with the suite's workers sharing the cores, one intra-op
    # thread a worker is several times faster than the default
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_lamb_trajectory_matches_optax():
    j_model, params, t_model = pair()
    data = batches(5, pads=[0, 1, 4, 0, 2, 7, 0, 3])
    schedule = dict(warmup_steps=2, training_steps=5)
    tx = jax_make_optimizer(jax_lrs.cosine_with_warmup(5e-3, **schedule), optimizer="lamb",
                            weight_decay=0.01, frozen_prefixes=FROZEN)
    mesh, state, shardings = _jax_state(tx)
    j_step = jax_make_train_step(jax_tasks.clm_loss_fn(j_model, LATENTS), mesh, shardings, grad_clip_norm=1.0)
    factory = make_optimizer(cosine_with_warmup(5e-3, **schedule), optimizer="lamb", weight_decay=0.01,
                             frozen_prefixes=FROZEN)
    t_state = TrainState.create(t_model, factory)
    assert isinstance(t_state.optimizer, Lamb)
    t_step = make_train_step(clm_loss_fn(t_model, LATENTS), grad_clip_norm=1.0, device="cpu")
    frozen = {n: p.detach().clone() for n, p in t_model.named_parameters()
              if n.startswith(("perceiver_ar.input_adapter.pos_embedding", "perceiver_ar.self_attention.layers.1.mlp"))}
    with mesh:
        for batch in data:
            state, j_metrics = j_step(state, shard_batch(batch, mesh), None)
            t_state, t_metrics = t_step(t_state, batch, None)
            np.testing.assert_allclose(t_metrics["loss"].item(), float(j_metrics["loss"]), rtol=LOSS_RTOL)
    assert t_state.step == 5 and len(frozen) == 5  # pos_embedding; the MLP's norm (2), hidden, out
    assert_params(t_model, state.params, rtol=1e-5, atol=1e-6)  # atol: entries near 0
    for name, before in frozen.items():
        assert torch.equal(dict(t_model.named_parameters())[name].detach(), before), name


def test_lamb_trust_ratio_is_one_at_a_zero_norm():
    zero = torch.zeros(3, requires_grad=True)
    live = torch.tensor([3.0, 4.0], requires_grad=True)
    opt = Lamb([zero, live], lr=0.1)
    zero.grad, live.grad = torch.tensor([1.0, -2.0, 0.5]), torch.tensor([0.0, 0.0])
    opt.step()
    # first step: m_hat / sqrt(v_hat) = sign(g); |p| = 0 -> ratio 1; u = 0 -> ratio 1
    np.testing.assert_allclose(zero.detach().numpy(), [-0.1, 0.1, -0.1], rtol=1e-5)
    np.testing.assert_array_equal(live.detach().numpy(), [3.0, 4.0])


def test_multi_steps_equal_single_steps_and_jax():
    data = batches(4, pads=[0, 1, 4, 0, 2, 7, 0, 3])
    stacked = {k: np.stack([b[k] for b in data]) for k in data[0]}
    # exact against four single steps, with prefix dropout from per-step generators
    models = []
    for multi in (False, True):
        _, _, model = pair(cross_attention_dropout=0.5)
        state = TrainState.create(model, make_optimizer(1e-2, optimizer="adamw", weight_decay=0.01))
        gens = [step_generator(7, i, torch.device("cpu")) for i in range(1, 5)]
        if multi:
            step = make_train_step(clm_loss_fn(model, LATENTS), grad_clip_norm=1.0, multi_steps=4,
                                   device="cpu")
            state, metrics = step(state, stacked, gens)
            assert metrics["loss"].shape == (4,) and metrics["grad_norm"].shape == (4,)
            multi_losses = metrics["loss"]
        else:
            step = make_train_step(clm_loss_fn(model, LATENTS), grad_clip_norm=1.0, device="cpu")
            losses = []
            for batch, gen in zip(data, gens):
                state, metrics = step(state, batch, gen)
                losses.append(metrics["loss"])
        assert state.step == 4
        models.append(model)
    assert torch.equal(torch.stack(losses), multi_losses)
    for (name, a), b in zip(models[0].named_parameters(), models[1].parameters()):
        assert torch.equal(a, b), name

    # against JAX's multi_steps (no dropout: the two packages' noise differs).
    # lr 1e-3: Adam's update of an entry whose gradient is near 0 is about
    # lr in size whatever the rounding of that gradient, so the params agree
    # to a few lr x 1e-3 (the gradients themselves at GRAD_TOL, test_torch_port_train)
    j_model, params, t_model = pair()
    tx = optax.adamw(1e-3, weight_decay=0.01)
    mesh, state, shardings = _jax_state(tx)
    j_multi = jax_make_train_step(jax_tasks.clm_loss_fn(j_model, LATENTS), mesh, shardings,
                                  grad_clip_norm=1.0, multi_steps=4)
    with mesh:
        state, j_metrics = j_multi(state, shard_batch(stacked, mesh, stacked_steps=True), None)
    t_state = TrainState.create(t_model, make_optimizer(1e-3, optimizer="adamw", weight_decay=0.01))
    t_multi = make_train_step(clm_loss_fn(t_model, LATENTS), grad_clip_norm=1.0, multi_steps=4, device="cpu")
    t_state, t_metrics = t_multi(t_state, stacked, None)
    np.testing.assert_allclose(t_metrics["loss"].numpy(), np.asarray(j_metrics["loss"]), rtol=LOSS_RTOL)
    assert int(state.step) == t_state.step == 4
    assert_params(t_model, state.params, **GRAD_TOL)


def test_multi_steps_refusals():
    _, _, model = pair()
    with pytest.raises(ValueError, match="multi_steps"):
        make_train_step(clm_loss_fn(model, LATENTS), multi_steps=0, device="cpu")
    step = make_train_step(clm_loss_fn(model, LATENTS), multi_steps=2, device="cpu")
    stacked = {k: np.stack([v, v]) for k, v in batches(1)[0].items()}
    with pytest.raises(ValueError, match="generators"):
        step(TrainState.create(model, make_optimizer(1e-3)), stacked, [None])


def test_ragged_block_raises_as_jax(tmp_path):
    good = batches(1, batch_size=8)[0]
    short = batches(1, batch_size=5, seed=1)[0]  # ragged: 5 != 8
    common = dict(max_steps=2, steps_per_execution=2, enable_checkpointing=False, enable_tensorboard=False)
    j_model, params, t_model = pair()
    j_trainer = JaxTrainer(JaxTrainerConfig(**common, default_root_dir=str(tmp_path / "jax")),
                           make_mesh(MeshConfig(data=1)), jax_tasks.clm_loss_fn(j_model, LATENTS),
                           optax.adam(1e-2))
    with pytest.raises(ValueError) as j_err:
        j_trainer.fit(lambda: params, iter([good, short]), initial_params=params)
    t_trainer = Trainer(TrainerConfig(**common, default_root_dir=str(tmp_path / "port")),
                        clm_loss_fn(t_model, LATENTS), make_optimizer(1e-2, optimizer="adam"), device="cpu")
    with pytest.raises(ValueError) as t_err:
        t_trainer.fit(t_model, iter([good, short]))
    assert str(t_err.value) == str(j_err.value)
    assert "steps_per_execution=2" in str(t_err.value)
    assert str([(8, SEQ), (8, SEQ)]) in str(t_err.value) and str([(5, SEQ), (5, SEQ)]) in str(t_err.value)
