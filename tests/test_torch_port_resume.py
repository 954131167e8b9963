"""The port's resume, preemption and non-finite recovery, on the CPU.

- A killed-and-resumed fit equals the uninterrupted one (the parameters
  and the optimizer state exactly, and the stitched ``metrics.jsonl``
  losses), also with ``steps_per_execution=4``; prefix dropout is on, from
  per-step generators.
- A SIGTERM sent to the process during step 4 finishes that step,
  snapshots, and a resumed fit continues to the uninterrupted losses.
- A stale snapshot is refused under ``rollback``; a mistyped ``resume``
  path raises ``FileNotFoundError`` and creates nothing.
- The ``ResumeCheckpointManager`` round trip (``max_to_keep``, skipped
  saves, the optimizer's and the scheduler's state, ``close``).
- ``DataLoader.skip_batches`` lands where the continuous stream is, and the
  loader's batches equal JAX's loader's.
- ``skip`` and ``rollback`` drills under the ported ``ChaosRegistry`` give
  the JAX ``Trainer``'s ``metrics.jsonl`` rows (losses rtol 1e-5, the rest
  equal, ``steps_per_sec`` aside) and ``fault_stats`` on the same script;
  a persistent divergence under ``rollback`` halts at the same step with
  JAX's message, and an injected streak under ``skip`` halts at its K-th
  step; an ``error`` fault raises after the step's update, as in JAX.
- A resume after a ``skip`` repeats a step in both packages (the
  reference's behaviour, ``ROADMAP.md`` C), with JAX's rows.
- ``profile_start`` writes one profiler trace.
"""
import json
import os
import signal
import threading

import numpy as np
import optax
import pytest
import torch

from tests._torch_port_training import LATENTS, LOSS_RTOL, batches, pair
from perceiver_io_tpu.data.loader import DataLoader as JaxDataLoader
from perceiver_io_tpu.parallel import MeshConfig, make_mesh
from perceiver_io_tpu.reliability import ChaosRegistry as JaxChaosRegistry
from perceiver_io_tpu.training import tasks as jax_tasks
from perceiver_io_tpu.training.trainer import Trainer as JaxTrainer
from perceiver_io_tpu.training.trainer import TrainerConfig as JaxTrainerConfig
from perceiver_io_tpu_torch.data import DataLoader
from perceiver_io_tpu_torch.parallel import TrainState, make_train_step
from perceiver_io_tpu_torch.reliability import ChaosRegistry
from perceiver_io_tpu_torch.training import (
    ResumeCheckpointManager, Trainer, TrainerConfig, clm_loss_fn, cosine_with_warmup, make_optimizer,
)

DATA = batches(6, batch_size=4)
QUIET = dict(val_check_interval=10_000, enable_checkpointing=False, enable_tensorboard=False, seed=7)


def _fit(root, max_steps, *, data=None, tx=None, chaos=None, dropout=0.5, **cfg):
    _, _, model = pair(cross_attention_dropout=dropout)
    cfg = {**QUIET, "log_every_n_steps": 1, **cfg}
    trainer = Trainer(TrainerConfig(max_steps=max_steps, default_root_dir=str(root), **cfg),
                      clm_loss_fn(model, LATENTS), tx or make_optimizer(1e-3), device="cpu", chaos=chaos)
    state = trainer.fit(model, DATA if data is None else data)
    return state, trainer


def _rows(root):
    return [json.loads(line) for line in open(os.path.join(root, "metrics.jsonl"))]


def _losses(root):
    return [(r["step"], r["train/loss"]) for r in _rows(root) if "train/loss" in r]


def _assert_states_equal(a: TrainState, b: TrainState):
    assert a.step == b.step
    for (name, x), y in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(x, y), name
    sa, sb = a.optimizer.state_dict()["state"], b.optimizer.state_dict()["state"]
    assert sa.keys() == sb.keys()
    for i in sa:
        for key in sa[i]:
            assert torch.equal(torch.as_tensor(sa[i][key]), torch.as_tensor(sb[i][key])), (i, key)


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
def straight_9(tmp_path_factory):
    root = tmp_path_factory.mktemp("straight")
    state, _ = _fit(root, 9)
    return state, _losses(root)


@pytest.mark.parametrize("spe", [1, 4])
def test_kill_and_resume_matches_uninterrupted(tmp_path, straight_9, spe):
    straight, straight_losses = straight_9
    _fit(tmp_path, 5, save_state_every_n_steps=5, steps_per_execution=spe)  # "dies" after step 5
    resumed, _ = _fit(tmp_path, 9, save_state_every_n_steps=5, steps_per_execution=spe, resume=str(tmp_path))
    assert resumed.step == 9
    _assert_states_equal(straight, resumed)
    assert {"step": 5, "resumed_at": 5.0} in _rows(tmp_path)
    if spe == 1:  # blocks log one mean a block, so only single steps give per-step rows
        assert _losses(tmp_path) == straight_losses  # stitched: steps 1..5 then 6..9


class _Preempting:
    """Batches that SIGTERM their own process while batch 4 is fetched
    (during step 4)."""

    def __init__(self, data):
        self.data, self.served = data, 0

    def __iter__(self):
        for batch in self.data:
            self.served += 1
            if self.served == 4:
                os.kill(os.getpid(), signal.SIGTERM)
            yield batch


def test_sigterm_preemption_snapshots_and_resumes(tmp_path, straight_9):
    assert threading.current_thread() is threading.main_thread()  # the handler's thread
    before = signal.getsignal(signal.SIGTERM)
    state, _ = _fit(tmp_path, 8, data=_Preempting(DATA), save_state_every_n_steps=100)
    assert state.step == 4 and signal.getsignal(signal.SIGTERM) == before
    assert ResumeCheckpointManager(str(tmp_path / "resume")).latest_step == 4
    assert {"step": 4, "preempted_at": 4.0} in _rows(tmp_path)
    resumed, _ = _fit(tmp_path, 8, save_state_every_n_steps=100, resume=str(tmp_path))
    assert resumed.step == 8
    assert _losses(tmp_path) == straight_9[1][:8]


def test_stale_snapshot_refused_and_mistyped_path_fails_clean(tmp_path):
    _fit(tmp_path, 4, save_state_every_n_steps=2)  # leaves snapshots 2 and 4
    with pytest.raises(ValueError, match="previous run"):
        _fit(tmp_path, 6, save_state_every_n_steps=2, non_finite_policy="rollback")
    with pytest.raises(ValueError, match="save_state_every_n_steps"):
        _fit(tmp_path / "b", 4, non_finite_policy="rollback")
    missing = tmp_path / "no-such-run"
    with pytest.raises(FileNotFoundError):
        ResumeCheckpointManager(str(missing), create=False)
    with pytest.raises(FileNotFoundError):
        _fit(tmp_path / "c", 2, resume=str(missing))
    assert not missing.exists()


def test_resume_manager_round_trip(tmp_path):
    def make_state():
        _, _, model = pair()
        schedule = cosine_with_warmup(1e-2, warmup_steps=2, training_steps=6)
        return TrainState.create(model, make_optimizer(schedule, optimizer="adamw", weight_decay=0.01))

    state = make_state()
    step = make_train_step(clm_loss_fn(state.model, LATENTS), device="cpu")
    manager = ResumeCheckpointManager(str(tmp_path), max_to_keep=2)
    for i, batch in enumerate(DATA[:4], 1):
        state, _ = step(state, batch, None)
        assert manager.save(i, state)
    assert manager.steps() == [3, 4] and manager.latest_step == 4
    assert not manager.save(4, state) and not manager.save(2, state)  # not after the latest
    restored = manager.restore_latest(make_state())
    _assert_states_equal(state, restored)
    assert restored.scheduler.last_epoch == state.scheduler.last_epoch == 4
    assert restored.optimizer.param_groups[0]["lr"] == state.optimizer.param_groups[0]["lr"]
    steps = [s["step"] for s in restored.optimizer.state.values()]
    assert steps and all(t.device.type == "cpu" and t.dtype == torch.float32 for t in steps)
    # the restored run goes on as the live one
    state, m1 = step(state, DATA[4], None)
    restored, m2 = step(restored, DATA[4], None)
    assert torch.equal(m1["loss"], m2["loss"])
    _assert_states_equal(state, restored)
    manager.close()
    manager.close()  # idempotent
    with pytest.raises(ValueError, match="closed"):
        manager.save(9, state)


def test_skip_batches_matches_continuous_stream_and_jax():
    data = [{"x": np.asarray([i]), "y": np.asarray([i, -i])} for i in range(10)]

    def stream(loader, count):
        out = []
        while len(out) < count:
            for b in loader:
                out.append(b)
                if len(out) == count:
                    break
        return out

    kw = dict(batch_size=2, shuffle=True, seed=3, shard_index=0, shard_count=1)
    continuous = stream(DataLoader(data, prefetch=0, **kw), 12)  # into a second epoch
    jax_continuous = stream(JaxDataLoader(data, prefetch=0, **kw), 12)
    prefetched = stream(DataLoader(data, prefetch=2, **kw), 12)
    for a, b, c in zip(continuous, jax_continuous, prefetched):
        assert a.keys() == b.keys() == c.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
            np.testing.assert_array_equal(a[k], c[k])
    skipped = DataLoader(data, prefetch=0, **kw)
    skipped.skip_batches(7)
    resumed = stream(skipped, 5)
    assert [int(b["x"][0, 0]) for b in resumed] == [int(b["x"][0, 0]) for b in continuous[7:]]


def _jax_fit(root, max_steps, *, chaos=None, tx=None, **cfg):
    j_model, params, _ = pair()
    cfg = {**QUIET, "log_every_n_steps": 1, **cfg}
    trainer = JaxTrainer(JaxTrainerConfig(max_steps=max_steps, default_root_dir=str(root), **cfg),
                         make_mesh(MeshConfig(data=1)), jax_tasks.clm_loss_fn(j_model, LATENTS),
                         tx or optax.adamw(1e-3), chaos=chaos)
    try:
        return trainer.fit(lambda: params, DATA, initial_params=params), trainer
    finally:
        trainer.close()


def _assert_rows_match(port_root, jax_root):
    port, ref = _rows(port_root), _rows(jax_root)
    assert len(port) == len(ref)
    for p, j in zip(port, ref):
        p.pop("train/steps_per_sec", None), j.pop("train/steps_per_sec", None)
        assert p.keys() == j.keys(), (p, j)
        for key in p:
            if key == "train/loss":
                np.testing.assert_allclose(p[key], j[key], rtol=LOSS_RTOL)
            else:
                assert p[key] == j[key], (key, p, j)


def _drill(tmp_path, build_chaos, max_steps, **cfg):
    """The same chaos script through both trainers: equal rows, fault
    counters, final step and fired faults."""
    jax_chaos, chaos = build_chaos(JaxChaosRegistry), build_chaos(ChaosRegistry)
    jax_state, jax_trainer = _jax_fit(tmp_path / "jax", max_steps, chaos=jax_chaos, **cfg)
    state, trainer = _fit(tmp_path / "port", max_steps, chaos=chaos, dropout=0.0, **cfg)
    _assert_rows_match(tmp_path / "port", tmp_path / "jax")
    assert trainer.fault_stats == jax_trainer.fault_stats
    assert state.step == int(jax_state.step)
    assert chaos.log and chaos.log == jax_chaos.log
    return state, trainer


def test_skip_drill_matches_jax(tmp_path):
    state, trainer = _drill(tmp_path, lambda cls: _nan(cls, 3), 6, non_finite_policy="skip")
    assert trainer.fault_stats == {"skipped_steps": 1, "rollbacks": 0, "callback_errors": 0}
    assert state.step == 5  # 6 steps walked, one update dropped


def test_rollback_drill_matches_jax(tmp_path):
    state, trainer = _drill(tmp_path, lambda cls: _nan(cls, 4, count=2), 8, non_finite_policy="rollback",
                            non_finite_rollback_after=2, save_state_every_n_steps=2)
    assert trainer.fault_stats == {"skipped_steps": 1, "rollbacks": 1, "callback_errors": 0}
    straight, _ = _fit(tmp_path / "straight", 8, dropout=0.0)
    _assert_states_equal(straight, state)  # the replay lands on the undisturbed run


def _nan(cls, step, count=1):
    chaos = cls()
    chaos.nan_loss_at_step(step, count=count)
    return chaos


def test_persistent_divergence_halts_like_jax(tmp_path):
    """A real blow-up under ``rollback`` (SGD at 1e38): every replay
    diverges again, and both packages halt after 2 rollbacks at the same
    step with the same message and the same rows."""
    kw = dict(non_finite_policy="rollback", non_finite_rollback_after=2, non_finite_max_rollbacks=2,
              save_state_every_n_steps=3)
    with pytest.raises(FloatingPointError) as j_err:
        _jax_fit(tmp_path / "jax", 12, tx=optax.sgd(1e38), **kw)
    with pytest.raises(FloatingPointError) as t_err:
        _fit(tmp_path / "port", 12, dropout=0.0, tx=make_optimizer(1e38, optimizer="sgd"), **kw)
    assert str(t_err.value) == str(j_err.value)
    _assert_rows_match(tmp_path / "port", tmp_path / "jax")


def test_persistent_skip_streak_halts(tmp_path):
    """K = 3 injected non-finite steps in a row under ``skip`` halt at the
    third (JAX's ``test_skip_policy_halts_on_persistent_streak`` script:
    NaN from executed step 2 on)."""
    with pytest.raises(FloatingPointError, match=r"non-finite for 3 consecutive steps \(last at step 4\)"):
        _fit(tmp_path, 8, dropout=0.0, chaos=_nan(ChaosRegistry, 2, count=10), non_finite_policy="skip",
             non_finite_rollback_after=3)


def test_chaos_error_raises_after_the_update_as_jax(tmp_path):
    """An ``error`` fault raises at the step boundary, after the step's
    update (JAX's order), under ``halt`` and under ``skip`` alike."""
    from perceiver_io_tpu_torch.reliability import InjectedFault

    for policy in ("halt", "skip"):
        chaos = ChaosRegistry()
        chaos.add("trainer.step", "error", 2)
        _, _, model = pair()
        trainer = Trainer(TrainerConfig(max_steps=4, default_root_dir=str(tmp_path / policy), **QUIET,
                                        non_finite_policy=policy),
                          clm_loss_fn(model, LATENTS), make_optimizer(1e-3), device="cpu", chaos=chaos)
        with pytest.raises(InjectedFault):
            trainer.fit(model, DATA)
        assert trainer.state.step == 2 and chaos.fired_count("trainer.step") == 1


def test_profile_start_records_a_trace(tmp_path):
    state, _ = _fit(tmp_path, 5, profile_start=2)
    assert state.step == 5
    traces = list((tmp_path / "profile").glob("*.json"))
    assert len(traces) == 1 and traces[0].stat().st_size > 0


def test_resume_after_a_skip_matches_jax(tmp_path):
    """A run that skipped step 3 and snapshotted at step 4 holds 3 updates,
    and both packages resume it at ``state.step + 1`` = 4: step 4 runs
    again (the reference's behaviour, logged in ``ROADMAP.md`` C; the port
    mirrors it). Rows, fault counters and the final step equal JAX's."""
    kw = dict(save_state_every_n_steps=2)
    _jax_fit(tmp_path / "jax", 4, chaos=_nan(JaxChaosRegistry, 3), non_finite_policy="skip", **kw)
    jax_state, _ = _jax_fit(tmp_path / "jax", 6, resume=str(tmp_path / "jax"), **kw)
    _fit(tmp_path / "port", 4, dropout=0.0, chaos=_nan(ChaosRegistry, 3), non_finite_policy="skip", **kw)
    state, _ = _fit(tmp_path / "port", 6, dropout=0.0, resume=str(tmp_path / "port"), **kw)
    _assert_rows_match(tmp_path / "port", tmp_path / "jax")
    assert {"step": 3, "resumed_at": 3.0} in _rows(tmp_path / "port")
    assert state.step == int(jax_state.step) == 6
