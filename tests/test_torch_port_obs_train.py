"""The port's trainer and CLI with telemetry, on the CPU.

- ``Trainer.fit`` for 3 steps with a tracer, a snapshot writer and a
  profiler trigger writes the same span names and steps, the same step
  count and the same snapshot keys as JAX's ``Trainer`` on the same
  converted weights and batches; its losses equal the same port fit
  without hooks, bit for bit, and its first equals JAX's at 1e-5.
- The CLI: ``serve --obs.events_path ... --obs.timeline.steps ...`` prints
  a non-null ``trace_id`` on every line, and ``serve_stats`` carries
  ``metrics``, ``compile_ledger`` and ``process_metrics``; ``obs report``,
  ``obs timeline`` and ``obs incident`` then render over what the run
  wrote (JAX's ``test_serve_cli_run_is_obs_reportable``). ``fit`` with
  ``--obs.*`` writes one ``trainer.step`` span per step.
"""
import json
import os

import numpy as np
import optax
import pytest
import torch

from perceiver_io_tpu.observability import MetricsRegistry as JaxRegistry
from perceiver_io_tpu.observability import ProfilerTrigger as JaxTrigger
from perceiver_io_tpu.observability import SnapshotWriter as JaxSnapshotWriter
from perceiver_io_tpu.observability import Tracer as JaxTracer
from perceiver_io_tpu.parallel import MeshConfig, make_mesh
from perceiver_io_tpu.training import tasks as jax_tasks
from perceiver_io_tpu.training.trainer import Trainer as JaxTrainer
from perceiver_io_tpu.training.trainer import TrainerConfig as JaxTrainerConfig
from perceiver_io_tpu_torch.models.text.clm import CausalLanguageModel, CausalLanguageModelConfig
from perceiver_io_tpu_torch.observability import (
    MetricsRegistry,
    ProfilerTrigger,
    SnapshotWriter,
    Tracer,
    default_ledger,
    default_registry,
    read_events_jsonl,
)
from perceiver_io_tpu_torch.reliability import FakeClock
from perceiver_io_tpu_torch.training import Trainer, TrainerConfig, clm_loss_fn, make_optimizer
from perceiver_io_tpu_torch.training.checkpoint import save_pretrained
from tests import _torch_port_obs as C

LATENTS = 8
STEPS = 3


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _batches(n, seed=1):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = rng.integers(0, C.TINY["vocab_size"], size=(4, C.N + 1), dtype=np.int32)
        out.append({"input_ids": ids[:, :-1], "labels": ids[:, 1:]})
    return out


def _losses(root):
    return [r["train/loss"] for r in map(json.loads, open(os.path.join(root, "metrics.jsonl")))
            if "train/loss" in r]


def _port_fit(root, hooks: bool):
    from perceiver_io_tpu_torch.convert.from_jax import load_jax_params

    _, params, _ = C.tiny_pair()
    model = load_jax_params(CausalLanguageModel(CausalLanguageModelConfig(**C.TINY), device="cpu"), params)
    kw = {}
    if hooks:
        reg = MetricsRegistry()
        kw = dict(registry=reg, tracer=Tracer(clock=FakeClock()),
                  snapshot_writer=SnapshotWriter(reg, os.path.join(root, "snap.json"), every_s=0.0),
                  profiler_trigger=ProfilerTrigger(os.path.join(root, "prof"), min_samples=2, warmup=0))
    trainer = Trainer(TrainerConfig(max_steps=STEPS, log_every_n_steps=1, enable_checkpointing=False,
                                    enable_tensorboard=False, default_root_dir=root),
                      clm_loss_fn(model, LATENTS), make_optimizer(1e-2, optimizer="adam"), device="cpu", **kw)
    state = trainer.fit(model, _batches(STEPS))
    return trainer, state, kw


def _jax_fit(root):
    j_model, params, _ = C.tiny_pair()
    reg = JaxRegistry()
    kw = dict(registry=reg, tracer=JaxTracer(clock=FakeClock()),
              snapshot_writer=JaxSnapshotWriter(reg, os.path.join(root, "snap.json"), every_s=0.0),
              profiler_trigger=JaxTrigger(os.path.join(root, "prof"), min_samples=2, warmup=0))
    trainer = JaxTrainer(JaxTrainerConfig(max_steps=STEPS, log_every_n_steps=1, enable_checkpointing=False,
                                          enable_tensorboard=False, default_root_dir=root),
                         make_mesh(MeshConfig(data=1)), jax_tasks.clm_loss_fn(j_model, LATENTS),
                         optax.adam(1e-2), **kw)
    trainer.fit(lambda: params, _batches(STEPS), initial_params=params)
    trainer.close()
    return trainer, kw


def _spans(tracer):
    return [(s.name, s.attrs.get("step"), s.attrs.get("measures"), s.status) for s in tracer.spans()]


def test_trainer_hooks_equal_jax_and_change_no_loss(tmp_path):
    t_trainer, state, t_kw = _port_fit(str(tmp_path / "port"), hooks=True)
    _, _, _ = _port_fit(str(tmp_path / "bare"), hooks=False)
    j_trainer, j_kw = _jax_fit(str(tmp_path / "jax"))
    assert state.step == STEPS
    # the hooks change no loss bit
    assert _losses(tmp_path / "port") == _losses(tmp_path / "bare")
    # step 1 runs both packages' forward on the same weights and batch
    np.testing.assert_allclose(_losses(tmp_path / "port")[0], _losses(tmp_path / "jax")[0], rtol=1e-5)
    # the same spans, steps and step count
    assert _spans(t_kw["tracer"]) == _spans(j_kw["tracer"])
    assert [n for n, *_ in _spans(t_kw["tracer"])].count("trainer.step") == STEPS
    assert len({s.trace_id for s in t_kw["tracer"].spans()}) == 1
    t_reg, j_reg = t_trainer.registry, j_trainer.registry
    assert t_reg.counters() == j_reg.counters() and t_reg.counter("trainer_steps_total") == STEPS
    assert sorted(t_reg.snapshot()["histograms"]) == sorted(j_reg.snapshot()["histograms"]) == ["trainer_step_ms"]
    assert sorted(t_reg.snapshot()["gauges"]) == sorted(j_reg.snapshot()["gauges"])
    # the snapshot writer: the same keys, forced once at the end of fit
    t_snap = json.load(open(tmp_path / "port" / "snap.json"))
    j_snap = json.load(open(tmp_path / "jax" / "snap.json"))
    assert sorted(t_snap) == sorted(j_snap)
    for key in ("counters", "gauges", "histograms"):
        assert sorted(t_snap[key]) == sorted(j_snap[key]), key
    # both triggers were fed each step's fenced time
    assert t_kw["profiler_trigger"].baseline_p95 is not None
    assert j_kw["profiler_trigger"].baseline_p95 is not None


def test_trainer_armed_trigger_captures_one_step(tmp_path):
    """An armed trigger runs the next single step under ``torch.profiler``
    and writes its Chrome trace; the loss does not change."""
    _, params, _ = C.tiny_pair()
    from perceiver_io_tpu_torch.convert.from_jax import load_jax_params

    model = load_jax_params(CausalLanguageModel(CausalLanguageModelConfig(**C.TINY), device="cpu"), params)
    trigger = ProfilerTrigger(str(tmp_path / "prof"), min_samples=1, warmup=0)
    trigger.arm()
    root = str(tmp_path / "run")
    trainer = Trainer(TrainerConfig(max_steps=2, log_every_n_steps=1, enable_checkpointing=False,
                                    enable_tensorboard=False, default_root_dir=root, steps_per_execution=2),
                      clm_loss_fn(model, LATENTS), make_optimizer(1e-2, optimizer="adam"), device="cpu",
                      profiler_trigger=trigger)
    trainer.fit(model, _batches(2))
    assert trigger.captures == 1 and (tmp_path / "prof" / "regress-step1" / "trace.json").exists()
    assert trainer.registry.counter("trainer_steps_total") == 2


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """One ``serve`` run of the port's CLI with ``--obs.*`` over a saved tiny
    model (vocab 262: the byte tokenizer's ids)."""
    from perceiver_io_tpu_torch.scripts.text import clm as port_clm

    tmp = tmp_path_factory.mktemp("serve_obs")
    cfg = CausalLanguageModelConfig(vocab_size=262, max_seq_len=32, max_latents=16, num_channels=16,
                                    num_heads=2, num_self_attention_layers=1)
    save_pretrained(str(tmp / "ckpt"), CausalLanguageModel(cfg, device="cpu"), cfg)
    # the third prompt is longer than the 16-position bucket: rejected, with a trace id
    (tmp / "prompts.txt").write_text("hello\nhi\nthe quick brown fox\n")
    ledger = default_ledger()
    # a build as the card's first kernel call records it
    ledger.record_build("kernel_build", {"source": "csrc/k.cu", "hash": "0123456789ab", "flags": "-O3"}, 1.5)
    paths = {k: str(tmp / f"{k}.json{'l' if k != 'snapshot' else ''}") for k in ("events", "timeline", "snapshot")}
    argv = ["serve", f"--ckpt={tmp / 'ckpt'}", "--device=cpu", f"--serve.prompts={tmp}/prompts.txt",
            "--serve.max_new_tokens=3", "--serve.num_latents=2", "--serve.engine=slots",
            "--serve.slots=2", "--serve.prompt_buckets=8,16", "--serve.decode_strategy=cached",
            "--serve.kv_layout=paged", "--serve.prefix_cache=off", "--serve.speculation=off",
            f"--obs.events_path={paths['events']}", f"--obs.snapshot_path={paths['snapshot']}",
            "--obs.timeline.steps=64", f"--obs.timeline.export={paths['timeline']}",
            f"--obs.incident.dir={tmp / 'incidents'}", "--obs.slo.ttft_p95_ms=1e6"]
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        results = port_clm.main(argv)
    yield tmp, paths, results, out.getvalue()
    ledger.reset()
    default_registry().reset("compile")
    default_registry().reset("retrace")


def test_serve_lines_carry_trace_ids(served):
    tmp, paths, results, stdout = served
    lines = [json.loads(line) for line in stdout.splitlines() if line.startswith("{")]
    rows = [r for r in lines if "serve_stats" not in r]
    assert [r["status"] for r in rows] == ["ok", "ok", "rejected"] and all(r["trace_id"] for r in rows)
    events = read_events_jsonl(paths["events"])
    terminal = {r["trace_id"] for r in events if r["span"] == "serving.request"}
    assert {r["trace_id"] for r in rows} == terminal
    stats = lines[-1]["serve_stats"]
    for key in ("metrics", "compile_ledger", "process_metrics", "slo", "incident", "timeline"):
        assert key in stats, key
    assert stats["metrics"]["counters"]["serving_requests_completed_total"] == 2
    assert stats["metrics"]["counters"]["serving_requests_rejected_total"] == 1
    assert any(r["site"] == "kernel_build" for r in stats["compile_ledger"]["records"])
    assert stats["process_metrics"]["counters"]["compile_total"] >= 1
    assert "kv_cache_resident_bytes" in stats["process_metrics"]["gauges"]


def test_obs_subcommands_render_the_run(served, capsys):
    from perceiver_io_tpu_torch.scripts.text import clm as port_clm

    tmp, paths, _, _ = served
    text = port_clm.main(["obs", "report", f"--events={paths['events']}", f"--snapshot={paths['snapshot']}"])
    assert "== compile/memory ledger ==" in text and "kernel_build" in text and "ttft" in text.lower()
    text = port_clm.main(["obs", "timeline", f"--timeline={paths['timeline']}", f"--events={paths['events']}"])
    assert "slot" in text.lower() and text
    snap = json.load(open(paths["snapshot"]))
    assert snap["compile_ledger"]["records"] and "process_metrics" in snap
    with pytest.raises(SystemExit, match="obs incident"):
        port_clm.main(["obs", "incident", f"--bundle={tmp / 'incidents' / 'missing'}"])


def test_fit_cli_obs_flags_write_step_spans(tmp_path):
    from perceiver_io_tpu_torch.scripts.text import clm as port_clm

    root = tmp_path / "fit"
    port_clm.main(["fit", "--data=synthetic", f"--data.dataset_dir={tmp_path / 'data'}", "--device=cpu",
                   "--data.max_seq_len=32", "--data.batch_size=2", "--data.num_train_docs=4",
                   "--data.num_valid_docs=2", "--data.doc_chars=256", "--model.max_latents=8",
                   "--model.num_channels=16", "--model.num_heads=2", "--model.num_self_attention_layers=1",
                   "--trainer.max_steps=3", "--trainer.log_every_n_steps=1", "--trainer.val_check_interval=100",
                   f"--trainer.default_root_dir={root}", "--trainer.enable_tensorboard=false",
                   "--obs.events_path=events.jsonl", "--obs.snapshot_every_s=0",
                   "--obs.profile_on_regress_factor=3.0"])
    rows = read_events_jsonl(str(root / "events.jsonl"))
    assert [r["attrs"]["step"] for r in rows if r["span"] == "trainer.step"] == [1, 2, 3]
    assert all(r["attrs"]["measures"] == "fenced" for r in rows if r["span"] == "trainer.step")
    snap = json.load(open(root / "metrics_snapshot.json"))
    assert snap["counters"]["trainer_steps_total"] == 3 and "trainer_step_ms" in snap["histograms"]
    with pytest.raises(SystemExit, match="applies to the serve subcommand"):
        port_clm.main(["fit", "--data=synthetic", "--device=cpu", "--obs.timeline.steps=4"])
