"""The port's CLI against the JAX package's, on the CPU.

- **Parsing**: the same argv gives equal model, trainer, optimizer, schedule
  and serve dataclasses (YAML ``--config`` and the family's link and
  defaults included), and bad flags the same ``SystemExit`` messages.
- **fit / validate / test**: both families swapped to fp32 inside the test
  (``dataclasses.replace(FAMILY, build_model=...)``) start from the same
  weights: a JAX ``save_pretrained`` dir carried into the port's by
  ``convert/from_jax.py``, passed as ``--params``. Logged fit losses and the
  ``validate``/``test`` metrics agree at 1e-5 relative; the symbolic
  family's ``validate`` and a 2-step ``fit`` too.
- **serve**: the same checkpoint and prompts file through both CLIs on both
  engines give equal JSON lines (``prompt``, ``completion``, ``status`` and
  the error record of an infeasible prompt); each line carries its own
  ``trace_id`` (a per-run prefix, so the ids differ between the runs).
- **Outer serving**: ``serve --serve.replicas=2`` (the fleet router) and
  ``--serve.autoscale.max=3`` (the autoscaler over a one-replica fleet) give
  JAX's lines; ``--serve.http.port=0 --serve.http.max_streams=2`` serves two
  streams over a socket with JAX's frames (less ``trace_id``); the fleet,
  autoscale and gateway flags' ``SystemExit`` messages are JAX's.
- **The serving mesh's checks**: ``--serve.mesh.*`` raises JAX's
  ``SystemExit`` for the bucket engine and for a fleet the world cannot hold
  (its sharded runs: ``test_torch_port_sharding.py``); ``--mesh.*`` runs
  (``test_torch_port_parallel_train.py``).

A tiny CLM (262-byte vocab, 64 context, 16 latents, 32 channels, 2 heads,
1 layer) over ``--data=synthetic`` (4 + 2 + 2 documents of 512 characters).
The CLM's JAX runs are shared per module; two JAX ``fit`` runs in all (the
CLM's and the symbolic family's).
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from perceiver_io_tpu.models.audio.symbolic import SymbolicAudioModel as JaxSAM
from perceiver_io_tpu.models.audio.symbolic import SymbolicAudioModelConfig as JaxSAMConfig
from perceiver_io_tpu.models.text.clm import CausalLanguageModel as JaxCLM
from perceiver_io_tpu.models.text.clm import CausalLanguageModelConfig as JaxCLMConfig
from perceiver_io_tpu.scripts import cli as jax_cli
from perceiver_io_tpu.scripts.audio import symbolic as jax_sam_script
from perceiver_io_tpu.scripts.text import clm as jax_clm_script
from perceiver_io_tpu.training import checkpoint as jax_checkpoint
from perceiver_io_tpu_torch.convert.from_jax import load_jax_params
from perceiver_io_tpu_torch.models.audio.symbolic import SymbolicAudioModel, SymbolicAudioModelConfig
from perceiver_io_tpu_torch.models.text.clm import CausalLanguageModel, CausalLanguageModelConfig
from perceiver_io_tpu_torch.scripts import cli as port_cli
from perceiver_io_tpu_torch.scripts.audio import symbolic as port_sam_script
from perceiver_io_tpu_torch.scripts.text import clm as port_clm_script
from perceiver_io_tpu_torch.training import checkpoint as port_checkpoint

LOSS_RTOL = 1e-5
MODEL = dict(vocab_size=262, max_seq_len=64, max_latents=16, num_channels=32, num_heads=2,
             num_self_attention_layers=1, cross_attention_dropout=0.0)
MODEL_FLAGS = [f"--model.{k}={v}" for k, v in MODEL.items() if k not in ("vocab_size", "max_seq_len")]
DATA_FLAGS = ["--data=synthetic", "--data.max_seq_len=64", "--data.batch_size=8",
              "--data.num_train_docs=4", "--data.num_valid_docs=2", "--data.doc_chars=512"]
TRAINER_FLAGS = ["--optimizer.lr=1e-3", "--lr_scheduler.warmup_steps=1", "--trainer.max_steps=4",
                 "--trainer.val_check_interval=2", "--trainer.log_every_n_steps=1",
                 "--trainer.grad_clip_norm=1.0", "--trainer.enable_checkpointing=false",
                 "--trainer.enable_tensorboard=false"]
# prompts of 2 to 30 bytes; 64 bytes exceeds the prefix capacity of its
# bucket (64 - 2 latents > 48) and 70 the largest bucket: two error records
PROMPTS = ["hello world", "ab", "the quick brown fox jumps over", "q" * 64, "x" * 70, "latent bottleneck"]


def _jax_family(script, model_cls):
    return dataclasses.replace(script.FAMILY, build_model=lambda cfg, dm: model_cls(cfg))


def _port_family(script, model_cls):
    return dataclasses.replace(script.FAMILY, build_model=lambda cfg, dm, **kw: model_cls(cfg, **kw))


JAX_CLM = _jax_family(jax_clm_script, JaxCLM)
PORT_CLM = _port_family(port_clm_script, CausalLanguageModel)


def _jax_main(family, argv):
    return jax_cli.CLI(family).main(argv)


def _port_main(family, argv):
    return port_cli.CLI(family).main(argv)


def _save_pair(root, jax_cfg, port_cfg, jax_model_cls, port_model_cls, name):
    """A JAX ``save_pretrained`` dir of seeded weights and the port's dir
    carried over from it by ``convert/from_jax.py``."""
    init = jax.jit(jax_model_cls(jax_cfg).init, static_argnums=2)
    params = init(jax.random.PRNGKey(0), jnp.zeros((1, jax_cfg.max_seq_len), jnp.int32),
                  jax_cfg.max_seq_len - jax_cfg.max_latents)["params"]
    jax_dir, port_dir = root / f"{name}_jax", root / f"{name}_port"
    jax_checkpoint.save_pretrained(str(jax_dir), jax.device_get(params), jax_cfg)
    loaded, _ = jax_checkpoint.load_pretrained(str(jax_dir))
    model = port_model_cls(port_cfg, device="cpu", seed=1)
    load_jax_params(model, jax.tree_util.tree_map(np.asarray, loaded))
    port_checkpoint.save_pretrained(str(port_dir), model, port_cfg)
    return str(jax_dir), str(port_dir)


def _losses(root):
    rows = [json.loads(line) for line in open(root / "metrics.jsonl")]
    return {key: [(r["step"], r[key]) for r in rows if key in r] for key in ("train/loss", "val/loss")}


def _serve(main, family, ckpt, prompts, engine, extra=()):
    argv = ["serve", f"--ckpt={ckpt}", f"--serve.prompts={prompts}", "--serve.max_new_tokens=6",
            "--serve.num_latents=2", "--serve.warmup=false", f"--serve.engine={engine}", *extra]
    if engine == "slots":
        argv += ["--serve.kv_layout=paged", "--serve.slots=2", "--serve.speculation=off"]
    return main(family, argv)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    # tiny shapes: one intra-op thread is many times faster on a busy host
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both CLIs over the same data and weights: fit, validate, test and
    serve on both engines."""
    root = tmp_path_factory.mktemp("cli")
    jax_dir, port_dir = _save_pair(root, JaxCLMConfig(**MODEL), CausalLanguageModelConfig(**MODEL),
                                   JaxCLM, CausalLanguageModel, "clm")
    data = [*DATA_FLAGS, f"--data.dataset_dir={root / 'data'}"]
    out = {"root": root, "jax_dir": jax_dir, "port_dir": port_dir}
    # the JAX side trains on a one-device mesh (the port runs on one device)
    _jax_main(JAX_CLM, ["fit", *data, *MODEL_FLAGS, *TRAINER_FLAGS, f"--params={jax_dir}",
                        "--mesh.data=1", f"--trainer.default_root_dir={root / 'jax_fit'}"])
    state = _port_main(PORT_CLM, ["fit", *data, *MODEL_FLAGS, *TRAINER_FLAGS, f"--params={port_dir}",
                                  "--device=cpu", f"--trainer.default_root_dir={root / 'port_fit'}"])
    out["port_state"] = state
    for sub in ("validate", "test"):
        argv = [sub, *data, *MODEL_FLAGS, *TRAINER_FLAGS, "--trainer.limit_test_batches=1",
                f"--trainer.default_root_dir={root / sub}"]
        out[f"jax_{sub}"] = _jax_main(JAX_CLM, [*argv, f"--ckpt={jax_dir}", "--mesh.data=1"])
        out[f"port_{sub}"] = _port_main(PORT_CLM, [*argv, f"--ckpt={port_dir}", "--device=cpu"])
    prompts = root / "prompts.txt"
    prompts.write_text("\n".join(PROMPTS) + "\n")
    out["prompts"] = str(prompts)
    for engine in ("bucket", "slots"):
        out[f"jax_serve_{engine}"] = _serve(_jax_main, JAX_CLM, jax_dir, prompts, engine)
        out[f"port_serve_{engine}"] = _serve(_port_main, PORT_CLM, port_dir, prompts, engine,
                                             ["--device=cpu"])
    return out


def test_fit_losses_match_jax(runs):
    jax_rows, port_rows = _losses(runs["root"] / "jax_fit"), _losses(runs["root"] / "port_fit")
    assert runs["port_state"].step == 4
    for key in ("train/loss", "val/loss"):
        assert [s for s, _ in port_rows[key]] == [s for s, _ in jax_rows[key]] and port_rows[key], key
        np.testing.assert_allclose([v for _, v in port_rows[key]], [v for _, v in jax_rows[key]],
                                   rtol=LOSS_RTOL, err_msg=key)
    assert port_rows["train/loss"][-1][1] < port_rows["train/loss"][0][1]


@pytest.mark.parametrize("sub", ["validate", "test"])
def test_evaluation_metrics_match_jax(runs, sub):
    port, ref = runs[f"port_{sub}"], runs[f"jax_{sub}"]
    assert sorted(port) == sorted(ref) == (["loss"] if sub == "validate" else ["test_loss"])
    for key in ref:
        np.testing.assert_allclose(port[key], float(ref[key]), rtol=LOSS_RTOL)


@pytest.mark.parametrize("engine", ["bucket", "slots"])
def test_serve_lines_match_jax(runs, engine, capsys):
    port, ref = runs[f"port_serve_{engine}"], runs[f"jax_serve_{engine}"]
    strip = [{k: v for k, v in row.items() if k != "trace_id"} for row in ref]
    assert [{k: v for k, v in row.items() if k != "trace_id"} for row in port] == strip
    ids = [row["trace_id"] for row in port]
    assert all(ids) and len(set(ids)) == len(ids) and all(row["trace_id"] for row in ref)
    assert [row["status"] for row in port] == ["ok"] * 3 + ["rejected"] * 2 + ["ok"]
    assert port[3]["error"].startswith("ValueError: ") and port[3]["error"] != port[4]["error"]
    assert "exceeds the largest bucket 64" in port[4]["error"]


def test_serve_prints_json_lines(runs, capsys):
    """Stdout holds one JSON line per prompt and the ``serve_stats`` line."""
    capsys.readouterr()
    results = _serve(_port_main, PORT_CLM, runs["port_dir"], runs["prompts"], "bucket", ["--device=cpu"])
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert lines[:-1] == results and len(results) == len(PROMPTS)
    stats = lines[-1]["serve_stats"]
    assert stats["completed"] == 4 and stats["rejected"] == 2 and stats["health"]["accepting"] is False


def test_symbolic_fit_matches_jax(tmp_path):
    """The symbolic-audio family from the same weights: ``validate``, and a
    2-step ``fit`` whose logged losses equal JAX's (the second JAX fit)."""
    kw = dict(vocab_size=389, max_seq_len=64, max_latents=16, num_channels=32, num_heads=2,
              num_self_attention_layers=1, cross_attention_dropout=0.0)
    jax_dir, port_dir = _save_pair(tmp_path, JaxSAMConfig(**kw), SymbolicAudioModelConfig(**kw),
                                   JaxSAM, SymbolicAudioModel, "sam")
    argv = ["--data=synthetic", "--data.max_seq_len=64", "--data.batch_size=8",
            "--data.num_train_pieces=4", "--data.num_valid_pieces=4", "--data.mean_piece_len=512",
            *[f"--model.{k}={v}" for k, v in kw.items() if k not in ("vocab_size", "max_seq_len")],
            "--trainer.max_steps=2", "--trainer.log_every_n_steps=1", "--trainer.val_check_interval=2",
            "--trainer.enable_checkpointing=false", "--trainer.enable_tensorboard=false",
            "--trainer.limit_val_batches=1", "--lr_scheduler.warmup_steps=1", "--optimizer.lr=1e-3"]
    jax_family, family = _jax_family(jax_sam_script, JaxSAM), _port_family(port_sam_script, SymbolicAudioModel)
    ref = _jax_main(jax_family, ["validate", *argv, f"--params={jax_dir}", "--mesh.data=1",
                                 f"--trainer.default_root_dir={tmp_path / 'jax_val'}"])
    port = _port_main(family, ["validate", *argv, f"--params={port_dir}", "--device=cpu",
                               f"--trainer.default_root_dir={tmp_path / 'port_val'}"])
    np.testing.assert_allclose(port["loss"], float(ref["loss"]), rtol=LOSS_RTOL)
    _jax_main(jax_family, ["fit", *argv, f"--params={jax_dir}", "--mesh.data=1",
                           f"--trainer.default_root_dir={tmp_path / 'jax'}"])
    state = _port_main(family, ["fit", *argv, f"--params={port_dir}", "--device=cpu",
                                f"--trainer.default_root_dir={tmp_path / 'port'}"])
    assert state.step == 2
    jax_rows, port_rows = _losses(tmp_path / "jax"), _losses(tmp_path / "port")
    for key in ("train/loss", "val/loss"):
        assert [s for s, _ in port_rows[key]] == [s for s, _ in jax_rows[key]] and port_rows[key], key
        np.testing.assert_allclose([v for _, v in port_rows[key]], [v for _, v in jax_rows[key]],
                                   rtol=LOSS_RTOL, err_msg=key)


def test_serve_refuses_the_symbolic_family(runs, tmp_path):
    kw = dict(vocab_size=389, max_seq_len=64, max_latents=16, num_channels=32, num_heads=2,
              num_self_attention_layers=1)
    cfg = SymbolicAudioModelConfig(**kw)
    port_checkpoint.save_pretrained(str(tmp_path / "sam"), SymbolicAudioModel(cfg, device="cpu"), cfg)
    with pytest.raises(SystemExit, match="serve currently supports text CLM checkpoints .*SymbolicAudioModel"):
        _serve(_port_main, PORT_CLM, tmp_path / "sam", runs["prompts"], "bucket", ["--device=cpu"])


# -- parsing ---------------------------------------------------------------
def _captured(cli_mod, family, argv, monkeypatch):
    """The dotted values ``main`` hands to ``run`` / ``run_serve``."""
    seen = {}
    monkeypatch.setattr(cli_mod.CLI, "run", lambda self, sub, data_cls, values: seen.update(
        sub=sub, data_cls=data_cls, values=values))
    monkeypatch.setattr(cli_mod.CLI, "run_serve", lambda self, values: seen.update(values=values))
    cli_mod.CLI(family).main(argv)
    return seen


def _plain(obj):
    """A dataclass as plain data (enums by name), for a cross-package compare."""
    def conv(v):
        return v.name if hasattr(v, "name") and hasattr(v, "value") else v
    return {k: conv(v) for k, v in dataclasses.asdict(obj).items()}


def _configs(cli_mod, trainer_cls, family, seen):
    values = dict(seen["values"])
    dm = seen["data_cls"](**{k.split(".", 1)[1]: v for k, v in values.items() if k.startswith("data.")})
    family.link(dm, values)
    return {
        "model": _plain(cli_mod.build_dataclass(family.config_class, values, "model", family.nested)),
        "trainer": _plain(cli_mod.build_dataclass(trainer_cls, values, "trainer")),
        "optimizer": _plain(cli_mod.build_dataclass(cli_mod.OptimizerArgs, values, "optimizer")),
        "lr_scheduler": _plain(cli_mod.build_dataclass(cli_mod.LRSchedulerArgs, values, "lr_scheduler")),
        "data": {k: getattr(v, "name", v) for k, v in values.items() if k.startswith("data.")},
    }


PARSE_ARGV = {
    "fit": ["fit", "--data=synthetic", "--model.num_heads=4", "--trainer.max_steps=7", "--optimizer.lr=2e-4",
            "--lr_scheduler.name=constant", "--trainer.grad_clip_norm=none", "--data.max_seq_len=128"],
    "validate-list": ["validate", "--data=list", "--data.train_texts=a,b", "--data.valid_texts=c",
                      "--data.dataset_dir=d", "--trainer.max_steps", "3", "--trainer.limit_val_batches=2",
                      "--model.max_latents=8", "--optimizer.b1=0.8"],
    "test-defaults": ["test", "--trainer.max_steps=1", "--data.task=mlm", "--data.random_train_shift=true",
                      "--model.init_scale=0.1", "--trainer.non_finite_policy=skip"],
    "yaml-config": ["fit", "--data=synthetic", "CONFIG", "--trainer.max_steps=2"],
}
# the symbolic family has no text list source and no task flag
PARSE_CASES = [("clm", name) for name in PARSE_ARGV] + [("symbolic", "fit"), ("symbolic", "yaml-config")]


@pytest.mark.parametrize("family,case", PARSE_CASES)
def test_parsed_configs_match_jax(family, case, tmp_path, monkeypatch):
    import yaml

    from perceiver_io_tpu.training.trainer import TrainerConfig as JaxTrainerConfig
    from perceiver_io_tpu_torch.training.trainer import TrainerConfig

    config = {"data.max_seq_len": 96, "model.num_channels": 64, "trainer.max_steps": 5,
              "trainer.enable_tensorboard": False, "lr_scheduler.warmup_steps": 3,
              "trainer.default_root_dir": str(tmp_path / "logs")}
    (tmp_path / "cfg.yaml").write_text(yaml.safe_dump(config))
    argv = [f"--config={tmp_path / 'cfg.yaml'}" if a == "CONFIG" else a for a in PARSE_ARGV[case]]
    if family == "symbolic":
        jax_family, port_family = jax_sam_script.FAMILY, port_sam_script.FAMILY
    else:
        jax_family, port_family = jax_clm_script.FAMILY, port_clm_script.FAMILY
    ref = _captured(jax_cli, jax_family, argv, monkeypatch)
    port = _captured(port_cli, port_family, argv, monkeypatch)
    assert port["sub"] == ref["sub"] and port["data_cls"].__name__ == ref["data_cls"].__name__
    assert {k: getattr(v, "name", v) for k, v in port["values"].items()} == \
        {k: getattr(v, "name", v) for k, v in ref["values"].items()}
    assert _configs(port_cli, TrainerConfig, port_family, port) == \
        _configs(jax_cli, JaxTrainerConfig, jax_family, ref)


def test_parsed_serve_args_match_jax(monkeypatch):
    argv = ["serve", "--ckpt=ckpt", "--serve.engine=slots", "--serve.kv_layout=paged",
            "--serve.prompt_buckets=32,64", "--serve.batch_buckets", "1,4", "--serve.seed=3",
            "--serve.max_new_tokens=9", "--serve.preemption=swap", "--serve.swap_gbps=4.5",
            "--serve.deadline_s=none", "--serve.warmup=no"]
    ref = _captured(jax_cli, jax_clm_script.FAMILY, argv, monkeypatch)["values"]
    port = _captured(port_cli, port_clm_script.FAMILY, argv, monkeypatch)["values"]
    assert port == ref
    assert dataclasses.asdict(port_cli.build_dataclass(port_cli.ServeArgs, port, "serve")) == \
        dataclasses.asdict(jax_cli.build_dataclass(jax_cli.ServeArgs, ref, "serve"))


def test_flag_engine_matches_jax():
    from typing import Optional, Tuple

    for text, tp in (("3", int), ("3.5", float), ("true", bool), ("no", bool), ("none", Optional[int]),
                     ("7", Optional[int]), ("1,2,3", Tuple[int, ...]), ("(4, 5)", Tuple[int, ...]),
                     ("abc", str)):
        assert port_cli._parse_value(text, tp) == jax_cli._parse_value(text, tp)
    for mod in (port_cli, jax_cli):
        with pytest.raises(ValueError, match="invalid bool"):
            mod._parse_value("maybe", bool)
    for argv in (["--data.text", "--help"], ["fit", "-h"], ["--x=1", "--help"]):
        assert port_cli._wants_help(argv) == jax_cli._wants_help(argv)
    assert set(port_cli.flag_specs(port_cli.ServeArgs, "serve")) == \
        set(jax_cli.flag_specs(jax_cli.ServeArgs, "serve"))
    from perceiver_io_tpu.observability import ObservabilityArgs
    assert set(port_cli.flag_specs(port_cli.ObservabilityArgs, "obs")) == \
        set(jax_cli.flag_specs(ObservabilityArgs, "obs"))


BAD_ARGV = {
    "unknown flag": ["fit", "--model.not_a_field=3"],
    "unexpected argument": ["fit", "stray"],
    "missing value": ["fit", "--trainer.max_steps"],
    "unknown subcommand": ["train"],
    "unknown data module": ["fit", "--data=nope"],
    "serve without ckpt": ["serve", "--serve.max_new_tokens=3"],
    "serve unknown flag": ["serve", "--serve.nope=1"],
}


def _same_exit(port: str, ref: str) -> None:
    """Equal messages; an unknown flag's hint lists the first 12 known flags,
    where the port's ``--device`` may take a place of JAX's."""
    head, _, listed = port.partition("; known flags include: ")
    if not listed:
        assert port == ref
        return
    ref_head, _, ref_listed = ref.partition("; known flags include: ")
    names, ref_names = listed.split(", ")[:-1], ref_listed.split(", ")[:-1]
    assert head == ref_head and names == sorted(set(ref_names) | {"device"})[:12]


@pytest.mark.parametrize("name", sorted(BAD_ARGV))
def test_bad_flags_exit_with_jax_messages(name):
    with pytest.raises(SystemExit) as ref:
        _jax_main(jax_clm_script.FAMILY, BAD_ARGV[name])
    with pytest.raises(SystemExit) as port:
        _port_main(port_clm_script.FAMILY, BAD_ARGV[name])
    _same_exit(str(port.value), str(ref.value))


BAD_SERVE = {
    "engine": ["--serve.engine=paged"],
    "decode_strategy": ["--serve.decode_strategy=fast"],
    "kv_layout on bucket": ["--serve.kv_layout=paged"],
    "prefill_chunk on bucket": ["--serve.prefill_chunk=8"],
    "headroom without preemption": ["--serve.engine=slots", "--serve.admit_headroom_blocks=2"],
    "swap_gbps without swap": ["--serve.engine=slots", "--serve.swap_gbps=2"],
    "step_timeout_s": ["--serve.step_timeout_s=1"],
    "replicas < 1": ["--serve.replicas=0"],
    "autoscale tuned without max": ["--serve.autoscale.min=2"],
    "autoscale max below replicas": ["--serve.replicas=3", "--serve.autoscale.max=2"],
    "scale_up_slots on bucket": ["--serve.autoscale.max=2", "--serve.autoscale.scale_up_slots=4"],
    "http with prompts": ["--serve.http.port=0"],
    "http stream": ["--serve.http.port=0", "--serve.http.stream=grpc", "--serve.prompts="],
}


@pytest.mark.parametrize("name", sorted(BAD_SERVE))
def test_bad_serve_flags_exit_with_jax_messages(runs, name):
    common = [f"--serve.prompts={runs['prompts']}", "--serve.warmup=false"]
    with pytest.raises(SystemExit) as ref:
        _jax_main(JAX_CLM, ["serve", f"--ckpt={runs['jax_dir']}", *common, *BAD_SERVE[name]])
    with pytest.raises(SystemExit) as port:
        _port_main(PORT_CLM, ["serve", f"--ckpt={runs['port_dir']}", "--device=cpu", *common,
                              *BAD_SERVE[name]])
    assert str(port.value) == str(ref.value)


# -- outer serving: the fleet, the autoscaler and the gateway --------------
def _http_serve(main, family, ckpt, prompts, extra, monkeypatch, gateway_cls):
    """``serve --serve.http.port=0 --serve.http.max_streams=N`` in a thread:
    each prompt POSTed in turn, its frames read (``trace_id`` dropped), then
    the CLI's return once the gateway stopped."""
    import http.client
    import threading

    started, out = [], {}
    run_in_thread = gateway_cls.run_in_thread

    def spy(self):
        started.append(run_in_thread(self))
        return started[-1]

    monkeypatch.setattr(gateway_cls, "run_in_thread", spy)
    argv = ["serve", f"--ckpt={ckpt}", "--serve.max_new_tokens=6", "--serve.num_latents=2",
            "--serve.warmup=false", "--serve.engine=slots", "--serve.kv_layout=paged", "--serve.slots=2",
            "--serve.speculation=off", "--serve.http.port=0", f"--serve.http.max_streams={len(prompts)}",
            *extra]
    thread = threading.Thread(target=lambda: out.update(ret=main(family, argv)))
    thread.start()
    for _ in range(2400):  # up to 2 minutes to load the checkpoint and bind
        if started or not thread.is_alive():
            break
        thread.join(0.05)
    assert started, "the serve CLI stopped before its gateway started"
    frames = []
    for p in prompts:
        conn = http.client.HTTPConnection(started[0].host, started[0].port, timeout=60)
        conn.request("POST", "/v1/generate", body=json.dumps({"prompt": p, "stream": "jsonl"}))
        resp = conn.getresponse()
        rows = [json.loads(line) for line in resp.read().decode().splitlines() if line.strip()]
        frames.append((resp.status, [{k: v for k, v in r.items() if k != "trace_id"} for r in rows]))
        conn.close()
    thread.join(120)
    return frames, out.get("ret")


OUTER = {
    "replicas": ["--serve.replicas=2"],
    "replicas failover off": ["--serve.replicas=2", "--serve.failover=false", "--serve.step_timeout_s=60"],
    "autoscale": ["--serve.autoscale.max=3"],
    "http": None,
}


@pytest.mark.parametrize("name", sorted(OUTER))
def test_outer_serving_flag_groups_run(runs, name, monkeypatch, capsys):
    if name == "http":
        from perceiver_io_tpu.serving import gateway as jax_gateway
        from perceiver_io_tpu_torch.serving import gateway as port_gateway

        prompts = PROMPTS[:2]
        ref, ref_ret = _http_serve(_jax_main, JAX_CLM, runs["jax_dir"], prompts, [], monkeypatch,
                                   jax_gateway.StreamingGateway)
        port, port_ret = _http_serve(_port_main, PORT_CLM, runs["port_dir"], prompts, ["--device=cpu"],
                                     monkeypatch, port_gateway.StreamingGateway)
        assert port == ref and port_ret == ref_ret == []
        assert [status for status, _ in port] == [200, 200]
        assert all(rows[-1]["done"] and rows[-1]["status"] == "ok" and len(rows) > 1 for _, rows in port)
        stats = json.loads(capsys.readouterr().out.splitlines()[-1])["serve_stats"]
        assert stats["gateway"]["streams_completed"] == 2 and stats["completed"] == 2
        return
    capsys.readouterr()
    ref = _serve(_jax_main, JAX_CLM, runs["jax_dir"], runs["prompts"], "slots", OUTER[name])
    ref_stats = json.loads(capsys.readouterr().out.splitlines()[-1])["serve_stats"]
    port = _serve(_port_main, PORT_CLM, runs["port_dir"], runs["prompts"], "slots", ["--device=cpu", *OUTER[name]])
    stats = json.loads(capsys.readouterr().out.splitlines()[-1])["serve_stats"]
    strip = [{k: v for k, v in row.items() if k != "trace_id"} for row in ref]
    assert [{k: v for k, v in row.items() if k != "trace_id"} for row in port] == strip
    # the fleet's lines are the single engine's
    assert port == [dict(row, trace_id=p["trace_id"]) for row, p in zip(runs["port_serve_slots"], port)]
    assert stats["engine"] == "fleet" and stats["completed"] == 4 and stats["rejected"] == 2
    # wall-clock cooldowns aside, the fleet and its autoscaler went as JAX's
    keys = [k for k in ref_stats if k.startswith("fleet_")] + ["replicas", "completed_by_replica", "failover"]
    assert {k: stats[k] for k in keys} == {k: ref_stats[k] for k in keys}
    assert (stats["autoscaler"] is None) == (name != "autoscale")
    if name == "autoscale":
        clockless = lambda a: {k: v for k, v in a.items() if not k.endswith("_remaining_s")}  # noqa: E731
        assert clockless(stats["autoscaler"]) == clockless(ref_stats["autoscaler"])
        # built at one replica; the queue of six over two slots scaled it up
        assert stats["autoscaler"]["max_replicas"] == 3 and stats["fleet_scale_up_total"] >= 1
        assert stats["replicas"] == 1 + stats["fleet_scale_up_total"] - stats["fleet_scale_down_total"]
    else:
        assert stats["replicas"] == 2 and stats["fleet_scale_up_total"] == 0


# -- the serving mesh's flag checks (the sharded runs: test_torch_port_sharding.py)
REFUSED = {
    # JAX's two SystemExit checks of --serve.mesh.*, made before the
    # checkpoint loads: the bucket engine, and a fleet the world cannot hold
    "serve mesh": (["serve", "--ckpt=c", "--serve.mesh.model=2"], "applies to --serve.engine=slots"),
    "serve mesh with replicas": (["serve", "--ckpt=c", "--serve.engine=slots", "--serve.replicas=2",
                                  "--serve.mesh.data=2"], "overruns"),
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_unported_flag_groups_raise_naming_the_item(name):
    argv, words = REFUSED[name]
    with pytest.raises(SystemExit, match=words):
        _port_main(port_clm_script.FAMILY, argv)


def test_help_lists_the_unported_groups(capsys):
    assert _port_main(port_clm_script.FAMILY, ["fit", "--help"]) is None
    out = capsys.readouterr().out
    assert "--device" in out and "A.5" not in out and "A.6" not in out
    # the serving mesh is ported: its flags are listed, not refused
    assert "--serve.mesh.data" in out and "--serve.mesh.model" in out and "--serve.mesh.device_offset" in out
    # outer serving is ported: its flags are listed, not refused
    assert "--serve.replicas=<n>" in out and "--serve.autoscale.max=<n>" in out and "--serve.http.port" in out
    # observability is ported: its flags and the obs subcommand are listed, not refused
    assert "A.4" not in out and "--obs.events_path" in out and "obs report" in out
    assert "data modules: ['bookcorpus', 'c4', 'enwik8', 'list', 'synthetic', 'wikipedia', 'wikitext']" in out
