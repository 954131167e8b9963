"""Port training slice against the JAX package, on the CPU: the loss, the LR
schedules, one-step loss and gradients, prefix dropout, the train step's
AdamW trajectory with clipping and accumulation, frozen parameters, and
``Trainer.fit``.

One tiny CLM (vocab 32, seq 16, 8 latents, 32 channels, 4 heads, 2 layers,
as ``tests/test_multi_step.py``); JAX params from a seed go through
``convert.from_jax`` into the port, and JAX gradients map the same way.
Batches are made with numpy from a seed and fed to both packages. fp32
throughout; tolerances: loss 1e-5 relative, gradients atol 1e-5 / rtol 1e-4
(same arithmetic, other summation orders), params after several Adam steps
atol 1e-5 / rtol 1e-4.
"""
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from perceiver_io_tpu.models.text.clm import CausalLanguageModel as JaxCLM
from perceiver_io_tpu.models.text.clm import CausalLanguageModelConfig as JaxConfig
from perceiver_io_tpu.parallel import MeshConfig, create_train_state, make_mesh, shard_batch
from perceiver_io_tpu.parallel import make_train_step as jax_make_train_step
from perceiver_io_tpu.training import lrs as jax_lrs
from perceiver_io_tpu.training import tasks as jax_tasks
from perceiver_io_tpu.training.optim import make_optimizer as jax_make_optimizer
from perceiver_io_tpu.training.trainer import Trainer as JaxTrainer
from perceiver_io_tpu.training.trainer import TrainerConfig as JaxTrainerConfig
from perceiver_io_tpu_torch.convert.from_jax import load_jax_params, state_dict_from_jax
from perceiver_io_tpu_torch.models.core import modules
from perceiver_io_tpu_torch.models.text.clm import CausalLanguageModel, CausalLanguageModelConfig
from perceiver_io_tpu_torch.parallel import TrainState, make_train_step
from perceiver_io_tpu_torch.training import (
    IGNORE_INDEX,
    BestCheckpointManager,
    Trainer,
    TrainerConfig,
    clm_loss_fn,
    constant_with_warmup,
    cosine_with_warmup,
    make_optimizer,
    masked_cross_entropy,
)

VOCAB, SEQ, LATENTS, CH, HEADS = 32, 16, 8, 32, 4
PREFIX = SEQ - LATENTS
LOSS_RTOL = 1e-5
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)


def _kw(dropout=0.0):
    return dict(vocab_size=VOCAB, max_seq_len=SEQ, max_latents=LATENTS, num_channels=CH,
                num_heads=HEADS, num_self_attention_layers=2, cross_attention_dropout=dropout)


@functools.lru_cache(maxsize=1)
def _jax_params():
    init = jax.jit(JaxCLM(JaxConfig(**_kw())).init, static_argnums=2)
    params = init(jax.random.PRNGKey(0), jnp.zeros((1, SEQ), jnp.int32), PREFIX)["params"]
    return jax.tree_util.tree_map(np.asarray, params)


def _pair(dropout=0.0):
    """JAX model, its params (numpy; the dropout rate adds none) and the port
    model with those params."""
    j_model = JaxCLM(JaxConfig(**_kw(dropout)))
    params = _jax_params()
    t_model = CausalLanguageModel(CausalLanguageModelConfig(**_kw(dropout)), device="cpu")
    load_jax_params(t_model, params)
    return j_model, params, t_model


def _batches(n, batch_size=8, seed=0, pads=None):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = rng.integers(0, VOCAB, size=(batch_size, SEQ + 1), dtype=np.int32)
        batch = {"input_ids": ids[:, :-1], "labels": ids[:, 1:]}
        if pads is not None:
            batch["pad_mask"] = np.arange(SEQ)[None, :] < np.asarray(pads)[:, None]
        out.append(batch)
    return out


def _jax_value_and_grad(j_model):
    return jax.jit(jax.value_and_grad(jax_tasks.clm_loss_fn(j_model, LATENTS), has_aux=True))


def _t(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _assert_grads(t_model, j_grads, **tol):
    expected = state_dict_from_jax(j_grads)
    for name, p in t_model.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name
        np.testing.assert_allclose(p.grad.numpy(), expected[name].numpy(), err_msg=name, **tol)


def _assert_params(t_model, j_params, **tol):
    expected = state_dict_from_jax(jax.device_get(j_params))
    for name, p in t_model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), expected[name].numpy(), err_msg=name, **tol)


def test_masked_cross_entropy_matches_jax(rng):
    logits = rng.standard_normal((3, 5, VOCAB)).astype(np.float32)
    labels = rng.integers(0, VOCAB, (3, 5))
    labels[0, :2] = IGNORE_INDEX
    labels[2, 4] = IGNORE_INDEX
    expected = jax_tasks.masked_cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    actual = masked_cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels))
    np.testing.assert_allclose(actual.item(), float(expected), rtol=1e-6)
    every = torch.full((3, 5), IGNORE_INDEX)  # no valid label: 0 / max(1, 0)
    assert masked_cross_entropy(torch.from_numpy(logits), every).item() == 0.0


@pytest.mark.parametrize("name", ["cosine", "constant"])
def test_lr_schedules_match_jax(name):
    if name == "cosine":
        kw = dict(warmup_steps=3, training_steps=10, min_fraction=0.1)
        pair = jax_lrs.cosine_with_warmup(2e-3, **kw), cosine_with_warmup(2e-3, **kw)
    else:
        pair = jax_lrs.constant_with_warmup(2e-3, warmup_steps=4), constant_with_warmup(2e-3, warmup_steps=4)
    for step in range(13):
        np.testing.assert_allclose(pair[1](step), float(pair[0](step)), rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("pads", [None, [0, 3, 10, 5]])  # 10 > prefix 8: pads reach a latent
def test_one_step_loss_and_grads_match_jax(pads):
    j_model, params, t_model = _pair()
    batch = _batches(1, batch_size=4, pads=pads)[0]
    (j_loss, _), j_grads = _jax_value_and_grad(j_model)(params, batch, None)
    loss, _ = clm_loss_fn(t_model, LATENTS)(t_model, _t(batch), None)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=LOSS_RTOL)
    _assert_grads(t_model, j_grads, **GRAD_TOL)


def test_prefix_dropout_same_noise_matches_jax(monkeypatch, rng):
    """Train mode with prefix dropout 0.5: both packages take the same
    uniform scores (JAX through ``jax.random.uniform``, the port through its
    ``prefix_noise`` seam) and give the same logits and gradients."""
    j_model, params, t_model = _pair(dropout=0.5)
    batch = _batches(1, batch_size=4, pads=[0, 2, 5, 7])[0]
    noise = rng.random((4, PREFIX)).astype(np.float32)
    monkeypatch.setattr(jax.random, "uniform", lambda key, shape, *a, **k: jnp.asarray(noise))
    monkeypatch.setattr(modules, "prefix_noise", lambda b, n, g, device: torch.from_numpy(noise))
    key = jax.random.PRNGKey(3)
    j_logits = jax.jit(lambda p, ids, pad: j_model.apply(
        {"params": p}, ids, PREFIX, pad_mask=pad, deterministic=False,
        rngs={"prefix": key, "dropout": key}))(params, batch["input_ids"], batch["pad_mask"])
    gen = torch.Generator().manual_seed(0)
    t_logits = t_model(_t(batch)["input_ids"], PREFIX, pad_mask=_t(batch)["pad_mask"],
                       deterministic=False, generator=gen)
    np.testing.assert_allclose(t_logits.detach().numpy(), np.asarray(j_logits), atol=1e-5, rtol=1e-5)

    (j_loss, _), j_grads = _jax_value_and_grad(j_model)(params, batch, key)
    loss, _ = clm_loss_fn(t_model, LATENTS)(t_model, _t(batch), gen)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=LOSS_RTOL)
    _assert_grads(t_model, j_grads, **GRAD_TOL)

    # keep = 8 - int(8 * 0.5) positions per row, the highest scores, in order
    idx = modules.prefix_keep_indices(torch.from_numpy(noise), 4)
    assert idx.shape == (4, 4) and (idx[:, 1:] > idx[:, :-1]).all()
    for row, kept in zip(noise, idx.numpy()):
        assert set(kept) == set(np.argsort(-row)[:4])


def test_train_step_adamw_trajectory_matches_jax():
    """AdamW with a scheduled learning rate, clipping at 1.0 and two
    microbatches: params after 3 steps equal JAX's ``make_train_step`` on a
    one-device mesh."""
    j_model, params, t_model = _pair()
    batches = _batches(3, pads=[0, 1, 4, 0, 2, 7, 0, 3])
    j_schedule = jax_lrs.cosine_with_warmup(3e-3, warmup_steps=1, training_steps=3)
    tx = jax_make_optimizer(j_schedule, optimizer="adamw", weight_decay=0.01)
    mesh = make_mesh(MeshConfig(data=1))
    state, shardings = create_train_state(lambda: params, tx, mesh, initial_params=params)
    j_step = jax_make_train_step(jax_tasks.clm_loss_fn(j_model, LATENTS), mesh, shardings,
                                 grad_clip_norm=1.0, grad_accum_steps=2)
    t_state = TrainState.create(t_model, make_optimizer(
        cosine_with_warmup(3e-3, warmup_steps=1, training_steps=3), optimizer="adamw", weight_decay=0.01))
    t_step = make_train_step(clm_loss_fn(t_model, LATENTS), grad_clip_norm=1.0, grad_accum_steps=2,
                             device="cpu")
    with mesh:
        for batch in batches:
            state, j_metrics = j_step(state, shard_batch(batch, mesh), None)
            t_state, t_metrics = t_step(t_state, batch, None)
            np.testing.assert_allclose(t_metrics["loss"].item(), float(j_metrics["loss"]), rtol=LOSS_RTOL)
            np.testing.assert_allclose(t_metrics["grad_norm"].item(), float(j_metrics["grad_norm"]),
                                       rtol=1e-5)
    assert t_state.step == 3
    _assert_params(t_model, state.params, **GRAD_TOL)


def test_frozen_prefixes_match_jax():
    j_model, params, t_model = _pair()
    frozen = ("perceiver_ar/cross_attention", "perceiver_ar/input_adapter/pos_embedding")
    batch = _batches(1, batch_size=4)[0]
    tx = jax_make_optimizer(1e-3, optimizer="adam", frozen_prefixes=frozen)
    mesh = make_mesh(MeshConfig(data=1))
    state, shardings = create_train_state(lambda: params, tx, mesh, initial_params=params)
    j_step = jax_make_train_step(jax_tasks.clm_loss_fn(j_model, LATENTS), mesh, shardings)
    with mesh:
        state, _ = j_step(state, shard_batch(batch, mesh), None)
    before = {k: v.clone() for k, v in t_model.state_dict().items()}
    t_state = TrainState.create(t_model, make_optimizer(1e-3, optimizer="adam", frozen_prefixes=frozen))
    make_train_step(clm_loss_fn(t_model, LATENTS), device="cpu")(t_state, batch, None)
    _assert_params(t_model, state.params, **GRAD_TOL)
    moments = {id(p) for p in t_state.optimizer.state}
    for name, p in t_model.named_parameters():
        is_frozen = name.startswith(("perceiver_ar.cross_attention.",
                                     "perceiver_ar.input_adapter.pos_embedding."))
        assert torch.equal(p.detach(), before[name]) == is_frozen, name
        assert (id(p) in moments) != is_frozen, name  # frozen: no moments


def test_trainer_fit_matches_jax(tmp_path):
    """4 steps with validation every 2: per-step train losses and val losses
    equal the JAX ``Trainer``'s; ``metrics.jsonl`` is written and the best
    checkpoint reloads into a model with the same validation loss."""
    j_model, params, t_model = _pair()
    train = _batches(3, seed=1)
    val = _batches(2, seed=99, pads=[0, 2, 4, 6, 0, 1, 3, 5])
    common = dict(max_steps=4, val_check_interval=2, log_every_n_steps=1, grad_clip_norm=1.0,
                  enable_tensorboard=False)
    j_trainer = JaxTrainer(
        JaxTrainerConfig(**common, enable_checkpointing=False, default_root_dir=str(tmp_path / "jax")),
        make_mesh(MeshConfig(data=1)), jax_tasks.clm_loss_fn(j_model, LATENTS), optax.adam(1e-2),
    )
    j_trainer.fit(lambda: params, train, val_data=lambda: iter(val), initial_params=params)
    cfg = CausalLanguageModelConfig(**_kw())
    t_trainer = Trainer(
        TrainerConfig(**common, default_root_dir=str(tmp_path / "port")),
        clm_loss_fn(t_model, LATENTS), make_optimizer(1e-2, optimizer="adam"),
        model_config=cfg, device="cpu",
    )
    state = t_trainer.fit(t_model, train, val_data=lambda: iter(val))
    assert state.step == 4

    def rows(root):
        return [json.loads(line) for line in open(root / "metrics.jsonl")]

    j_rows, t_rows = rows(tmp_path / "jax"), rows(tmp_path / "port")
    for key in ("train/loss", "val/loss"):
        j_vals = [(r["step"], r[key]) for r in j_rows if key in r]
        t_vals = [(r["step"], r[key]) for r in t_rows if key in r]
        assert [s for s, _ in t_vals] == [s for s, _ in j_vals] and t_vals, key
        np.testing.assert_allclose([v for _, v in t_vals], [v for _, v in j_vals], rtol=LOSS_RTOL)

    val_losses = {r["step"]: r["val/loss"] for r in t_rows if "val/loss" in r}
    ckpt = BestCheckpointManager(str(tmp_path / "port" / "checkpoints"))
    assert ckpt.best_step == min(val_losses, key=val_losses.get)
    state_dict, config = ckpt.restore_best()
    assert config["class"] == "CausalLanguageModelConfig" and config["vocab_size"] == VOCAB
    restored = CausalLanguageModel(CausalLanguageModelConfig(**{k: v for k, v in config.items()
                                                                if k != "class"}), device="cpu", seed=5)
    restored.load_state_dict(state_dict, strict=True)
    t_trainer.state = TrainState.create(restored, make_optimizer(1e-2))
    np.testing.assert_allclose(t_trainer.validate(iter(val))["loss"], val_losses[ckpt.best_step],
                               rtol=1e-6)


def test_best_checkpoints_keep_the_lowest(tmp_path):
    _, _, t_model = _pair()
    ckpt = BestCheckpointManager(str(tmp_path), max_to_keep=2)
    for step, loss in ((1, 3.0), (2, 1.0), (3, 2.0), (4, 5.0)):
        ckpt.save(step, t_model, None, loss)
    assert sorted(p.name for p in tmp_path.iterdir() if p.is_dir()) == ["2", "3"]
    assert ckpt.best_step == 2


def _unported_cases():
    return [
        ("resume", lambda: TrainerConfig(max_steps=1, resume="x")),
        ("save_state_every_n_steps", lambda: TrainerConfig(max_steps=1, save_state_every_n_steps=2)),
        ("steps_per_execution", lambda: TrainerConfig(max_steps=1, steps_per_execution=2)),
        ("skip", lambda: TrainerConfig(max_steps=1, non_finite_policy="skip")),
        ("rollback", lambda: TrainerConfig(max_steps=1, non_finite_policy="rollback")),
        ("shard_seq", lambda: TrainerConfig(max_steps=1, shard_seq=True)),
        ("profile_start", lambda: TrainerConfig(max_steps=1, profile_start=1)),
    ]


@pytest.mark.parametrize("name,make_cfg", _unported_cases(), ids=[c[0] for c in _unported_cases()])
def test_unported_trainer_options_raise(tmp_path, name, make_cfg):
    cfg = make_cfg()
    cfg.default_root_dir = str(tmp_path)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Trainer(cfg, lambda *a: None, make_optimizer(1e-3), device="cpu")


@pytest.mark.parametrize("hook", ["chaos", "tracer", "snapshot_writer"])
def test_unported_trainer_hooks_raise(tmp_path, hook):
    cfg = TrainerConfig(max_steps=1, default_root_dir=str(tmp_path))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Trainer(cfg, lambda *a: None, make_optimizer(1e-3), device="cpu", **{hook: object()})


@pytest.mark.parametrize("case", ["multi_steps", "mesh", "lamb", "remat", "offload",
                                  "attention_dropout", "residual_dropout"])
def test_unported_training_features_raise(case):
    with pytest.raises(NotImplementedError):
        if case == "multi_steps":
            make_train_step(lambda *a: None, multi_steps=2, device="cpu")
        elif case == "mesh":
            make_train_step(lambda *a: None, mesh=object(), device="cpu")
        elif case == "lamb":
            make_optimizer(1e-3, optimizer="lamb")
        elif case in ("remat", "offload"):
            flag = "activation_checkpointing" if case == "remat" else "activation_offloading"
            CausalLanguageModel(CausalLanguageModelConfig(**_kw(), **{flag: True}), device="cpu")
        else:
            rate = "post_attention_dropout" if case == "attention_dropout" else "residual_dropout"
            model = CausalLanguageModel(CausalLanguageModelConfig(**_kw(), **{rate: 0.1}), device="cpu")
            model(torch.zeros(1, SEQ, dtype=torch.long), PREFIX, deterministic=False)
