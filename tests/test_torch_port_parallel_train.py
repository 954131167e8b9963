"""The port's trainer, checkpoints, multi-process runtime and CLI over a
mesh, against the JAX package's, on the CPU.

- ``Trainer.fit`` over a ``data=2`` world with prefix dropout 0.5 (both
  packages fed one noise table: JAX through ``jax.random.uniform``, the
  port through ``modules.prefix_noise``; a rank keeps its rows) equals
  JAX's ``Trainer`` on ``MeshConfig(data=2)``; with a root per rank, rank 1
  writes nothing.
- A snapshot written under ``fsdp=2`` resumes under ``data=2`` and under no
  mesh (this process), continuing the uninterrupted run's losses at rtol
  2e-4; resumed on ``fsdp=2`` it continues it bit for bit.
- Two ranks through ``initialize``, ``host_shard_info``, the
  ``DataLoader``'s rank sharding and ``shard_or_assemble`` give the loss of
  one process's step over the whole batch (JAX's ``_multihost_worker.py``).
- ``torchrun --nproc_per_node=2`` of ``fit --mesh.data=2 --device=cpu``
  gives the JAX CLI's ``--mesh.data=2`` losses at rtol 2e-4, and rank 0
  alone writes the run directory's rows.
"""
import dataclasses
import json
import os
import signal
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests._torch_port_parallel import CLM_KW, LATENTS, PREFIX, REPO, SEQ, TRAJ_RTOL, clm_batches, run_world
from perceiver_io_tpu.models.text.clm import CausalLanguageModel as JaxCLM
from perceiver_io_tpu.models.text.clm import CausalLanguageModelConfig as JaxCLMConfig
from perceiver_io_tpu.parallel import MeshConfig as JaxMeshConfig
from perceiver_io_tpu.parallel import make_mesh as jax_make_mesh
from perceiver_io_tpu.scripts import cli as jax_cli
from perceiver_io_tpu.scripts.text import clm as jax_clm_script
from perceiver_io_tpu.training import checkpoint as jax_checkpoint
from perceiver_io_tpu.training import tasks as jax_tasks
from perceiver_io_tpu.training.trainer import Trainer as JaxTrainer
from perceiver_io_tpu.training.trainer import TrainerConfig as JaxTrainerConfig
from perceiver_io_tpu_torch.convert.from_jax import load_jax_params, state_dict_from_jax
from perceiver_io_tpu_torch.models.text.clm import CausalLanguageModel, CausalLanguageModelConfig
from perceiver_io_tpu_torch.parallel import TrainState, make_train_step
from perceiver_io_tpu_torch.training import Trainer, TrainerConfig, clm_loss_fn, make_optimizer
from perceiver_io_tpu_torch.training import checkpoint as port_checkpoint

DROP_KW = {**CLM_KW, "cross_attention_dropout": 0.5}
TRAINER = dict(max_steps=4, log_every_n_steps=1, grad_clip_norm=1.0, enable_tensorboard=False,
               enable_checkpointing=False)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    # tiny shapes: with the suite's workers sharing the cores, one intra-op
    # thread a worker is several times faster than the default
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _params():
    j_model = JaxCLM(JaxCLMConfig(**CLM_KW))
    shapes = jax.eval_shape(lambda: j_model.init(jax.random.PRNGKey(0), jnp.zeros((1, SEQ), jnp.int32), PREFIX))
    rng = np.random.default_rng(0)
    return jax.tree_util.tree_map(lambda s: (rng.standard_normal(s.shape) * 0.1).astype(np.float32),
                                  shapes["params"])


def _build(**kw):
    return ("perceiver_io_tpu_torch.models.text.clm", "CausalLanguageModel", CausalLanguageModelConfig(**kw), {})


def _rows(rows, key="train/loss"):
    return [(r["step"], r[key]) for r in rows if key in r]


NOISE = np.random.default_rng(5).random((8, PREFIX)).astype(np.float32)


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    root = tmp_path_factory.mktemp("train")
    sd = state_dict_from_jax(_params())
    common = dict(state_dict=sd, loss=("clm_loss_fn", (LATENTS,)), batches=clm_batches())
    snap = dict(TRAINER, save_state_every_n_steps=2)
    half = dict(snap, max_steps=2)
    cases = [
        ("dropout_data2", "trainer_fit", dict(common, build=_build(**DROP_KW), mesh=dict(data=2),
                                              root=str(root / "dropout"), trainer=TRAINER, noise=NOISE)),
        ("own_roots", "trainer_fit", dict(common, build=_build(**CLM_KW), mesh=dict(data=2),
                                          root=str(root / "own"), trainer=dict(TRAINER, max_steps=1),
                                          per_rank_root=True)),
        ("straight", "trainer_fit", dict(common, build=_build(**CLM_KW), mesh=dict(data=1, fsdp=2),
                                         root=str(root / "straight"), trainer=snap)),
        ("first_half", "trainer_fit", dict(common, build=_build(**CLM_KW), mesh=dict(data=1, fsdp=2),
                                           root=str(root / "half"), trainer=half)),
        ("resume_data2", "trainer_fit", dict(common, build=_build(**CLM_KW), mesh=dict(data=2),
                                             root=str(root / "resume_data2"), trainer=TRAINER,
                                             resume=str(root / "half"))),
        ("resume_fsdp2", "trainer_fit", dict(common, build=_build(**CLM_KW), mesh=dict(data=1, fsdp=2),
                                             root=str(root / "resume_fsdp2"), trainer=TRAINER,
                                             resume=str(root / "half"))),
        ("multihost", "multihost", dict(build=_build(**CLM_KW), state_dict=sd, loss=("clm_loss_fn", (LATENTS,)),
                                        dataset=_dataset(), batch_size=2)),
    ]
    return {"root": root, "ranks": run_world(root, 2, cases)}


def _dataset():
    b = clm_batches(1, seed=7)[0]
    return [{k: v[i] for k, v in b.items()} for i in range(8)]


def test_trainer_fit_data2_with_prefix_dropout_matches_jax(world2, tmp_path, monkeypatch):
    params = _params()
    j_model = JaxCLM(JaxCLMConfig(**DROP_KW))
    monkeypatch.setattr(jax.random, "uniform", lambda key, shape, *a, **k: jnp.asarray(NOISE))
    j_trainer = JaxTrainer(JaxTrainerConfig(**TRAINER, default_root_dir=str(tmp_path)),
                           jax_make_mesh(JaxMeshConfig(data=2)), jax_tasks.clm_loss_fn(j_model, LATENTS),
                           optax.adam(1e-2))
    j_trainer.fit(lambda: params, clm_batches(), initial_params=params)
    j_rows = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    rows = world2["ranks"][0]["dropout_data2"]["rows"]
    assert [s for s, _ in _rows(rows)] == [s for s, _ in _rows(j_rows)] == [1, 2, 3, 4]
    np.testing.assert_allclose([v for _, v in _rows(rows)], [v for _, v in _rows(j_rows)], rtol=TRAJ_RTOL)


def test_only_rank_zero_writes(world2):
    ranks = world2["ranks"]
    assert ranks[0]["own_roots"]["wrote"] == ["metrics.jsonl"]
    assert ranks[1]["own_roots"]["wrote"] is None and ranks[1]["dropout_data2"]["rows"] is None


def test_snapshot_resumes_on_another_mesh_or_none(world2, tmp_path):
    """The snapshot of step 2 under ``fsdp=2`` holds the whole state: it
    resumes under ``data=2``, under ``fsdp=2`` (bit for bit) and in this
    process without a mesh, each continuing the uninterrupted run."""
    r0 = world2["ranks"][0]
    straight = _rows(r0["straight"]["rows"])
    assert [s for s, _ in straight] == [1, 2, 3, 4]
    tail = [v for s, v in straight if s > 2]
    for case in ("resume_data2", "resume_fsdp2"):
        got = _rows(r0[case]["rows"])
        assert [s for s, _ in got] == [3, 4], case
        np.testing.assert_allclose([v for _, v in got], tail, rtol=TRAJ_RTOL, err_msg=case)
    assert [v for _, v in _rows(r0["resume_fsdp2"]["rows"])] == tail
    for name, value in r0["straight"]["params"].items():
        assert np.array_equal(r0["resume_fsdp2"]["params"][name], value), name
    # the snapshot is the unsharded file: a run on one device continues it
    model = CausalLanguageModel(CausalLanguageModelConfig(**CLM_KW), device="cpu", seed=3)
    trainer = Trainer(TrainerConfig(**TRAINER, default_root_dir=str(tmp_path),
                                    resume=str(world2["root"] / "half")),
                      clm_loss_fn(model, LATENTS), make_optimizer(1e-2, optimizer="adam"), device="cpu")
    trainer.fit(model, clm_batches())
    got = _rows([json.loads(line) for line in open(tmp_path / "metrics.jsonl")])
    np.testing.assert_allclose([v for _, v in got], tail, rtol=TRAJ_RTOL)
    snap = torch.load(world2["root"] / "half" / "resume" / "2" / port_checkpoint.STATE_FILE, weights_only=True)
    assert {k: tuple(v.shape) for k, v in snap["model"].items()} == {
        k: tuple(v.shape) for k, v in model.state_dict().items()}


def test_two_processes_give_one_process_step_over_the_whole_batch(world2):
    """Rank r's loader yields rows r, r + 2, ... of the dataset; the global
    batch is the ranks' rows in rank order, and the step's loss is one
    process's over it."""
    ranks = [r["multihost"] for r in world2["ranks"]]
    data = _dataset()
    assert ranks[0]["rows"] == [data[i]["input_ids"].tolist() for i in (0, 2)]
    assert ranks[1]["rows"] == [data[i]["input_ids"].tolist() for i in (1, 3)]
    whole = {k: np.stack([data[i][k] for i in (0, 2, 1, 3)]) for k in data[0]}
    model = CausalLanguageModel(CausalLanguageModelConfig(**CLM_KW), device="cpu")
    load_jax_params(model, _params())
    step = make_train_step(clm_loss_fn(model, LATENTS), device="cpu")
    _, metrics = step(TrainState.create(model, make_optimizer(1e-2, optimizer="adam")), whole, None)
    for r in ranks:
        np.testing.assert_allclose(r["loss"], float(metrics["loss"]), rtol=1e-6)


# -- the CLI under torchrun ----------------------------------------------------

CLI_MODEL = dict(vocab_size=262, max_seq_len=64, max_latents=16, num_channels=32, num_heads=2,
                 num_self_attention_layers=1, cross_attention_dropout=0.0)
CLI_FLAGS = [f"--model.{k}={v}" for k, v in CLI_MODEL.items() if k not in ("vocab_size", "max_seq_len")]
CLI_DATA = ["--data=synthetic", "--data.max_seq_len=64", "--data.num_train_docs=4", "--data.num_valid_docs=2",
            "--data.doc_chars=512"]
CLI_TRAINER = ["--optimizer.lr=1e-3", "--lr_scheduler.warmup_steps=1", "--trainer.max_steps=3",
               "--trainer.val_check_interval=3", "--trainer.log_every_n_steps=1",
               "--trainer.grad_clip_norm=1.0", "--trainer.enable_checkpointing=false",
               "--trainer.enable_tensorboard=false"]


def test_cli_fit_under_torchrun_matches_jax_cli(tmp_path):
    j_cfg = JaxCLMConfig(**CLI_MODEL)
    init = jax.jit(JaxCLM(j_cfg).init, static_argnums=2)
    params = init(jax.random.PRNGKey(0), jnp.zeros((1, 64), jnp.int32), 48)["params"]
    jax_dir, port_dir = tmp_path / "jax_w", tmp_path / "port_w"
    jax_checkpoint.save_pretrained(str(jax_dir), jax.device_get(params), j_cfg)
    model = CausalLanguageModel(CausalLanguageModelConfig(**CLI_MODEL), device="cpu", seed=1)
    load_jax_params(model, jax.tree_util.tree_map(np.asarray, params))
    port_checkpoint.save_pretrained(str(port_dir), model, CausalLanguageModelConfig(**CLI_MODEL))
    data = [*CLI_DATA, f"--data.dataset_dir={tmp_path / 'data'}"]

    family = dataclasses.replace(jax_clm_script.FAMILY, build_model=lambda cfg, dm: JaxCLM(cfg))
    jax_cli.CLI(family).main(["fit", *data, "--data.batch_size=8", *CLI_FLAGS, *CLI_TRAINER,
                              f"--params={jax_dir}", "--mesh.data=2",
                              f"--trainer.default_root_dir={tmp_path / 'jax_fit'}"])
    env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
    env.update(OMP_NUM_THREADS="1")
    argv = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node=2",
            os.path.join(REPO, "tests", "_torch_port_cli_rank.py"), "fit", *data, "--data.batch_size=4",
            *CLI_FLAGS, *CLI_TRAINER, f"--params={port_dir}", "--mesh.data=2", "--device=cpu",
            f"--trainer.default_root_dir={tmp_path / 'port_fit'}"]
    # its own process group: a run past the limit is killed with every rank it started
    proc = subprocess.Popen(argv, env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        _, err = proc.communicate(timeout=300)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise
    assert proc.returncode == 0, err[-4000:]

    def rows(root):
        return [json.loads(line) for line in open(root / "metrics.jsonl")]

    j_rows, p_rows = rows(tmp_path / "jax_fit"), rows(tmp_path / "port_fit")
    for key in ("train/loss", "val/loss"):
        assert [s for s, _ in _rows(p_rows, key)] == [s for s, _ in _rows(j_rows, key)] and _rows(j_rows, key), key
        np.testing.assert_allclose([v for _, v in _rows(p_rows, key)], [v for _, v in _rows(j_rows, key)],
                                   rtol=TRAJ_RTOL, err_msg=key)
