"""The text classifier of the port against the JAX package, on the CPU
(mirrors the classifier cases of ``tests/test_task_models.py``,
``tests/test_pipelines.py`` and ``tests/test_cli_families.py``).

- **Model**: logits with a pad mask, ``classifier_loss_fn``'s loss, accuracy
  and gradients against ``jax.grad``, from the same seeded JAX weights
  carried over by ``convert/from_jax.py``, at atol/rtol 1e-5 in fp32
  (gradients at rtol 1e-4 beside atol 1e-5, as the masked LM's).
- **Warm start**: a JAX masked LM's weights go to the port through
  ``from_jax`` and are saved by the port's ``save_pretrained``; the JAX
  family's warm start from the JAX save and the port family's from the
  port's give equal logits.
- **Two-stage CLI fit**: both CLIs' ``fit`` with ``--model.encoder.params``,
  frozen (``--model.encoder.freeze=true``) and then unfrozen, from the same
  decoder weights, log the same losses at 1e-5 relative; under freeze the
  port's encoder ends bit-identical to the loaded one and its decoder moves.
- **Pipelines**: ``sentiment-analysis`` / ``text-classification`` labels and
  scores equal JAX's; ``pipeline_from_pretrained`` serves a saved model.
- **Config**: the config dict round-trips between the packages.
- **Published width**: at language-perceiver width with the CLI's decoder
  (1 query of 1280 channels, 8 heads, 2 classes) both packages count
  206,098,690 parameters (the port's modules built on the meta device).

One tiny config (vocab 262, 32 positions, 16 input channels, 4 latents of
16 channels, 2 heads, q/k channels unlike v in the encoder, one output query
of 12 channels, 2 classes), weights drawn from a seeded numpy generator.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perceiver_io_tpu.data.text.preprocessor import TextPreprocessor as JaxPreprocessor
from perceiver_io_tpu.data.text.tokenizers import ByteTokenizer as JaxByteTokenizer
from perceiver_io_tpu.inference import pipeline as jax_pipeline
from perceiver_io_tpu.models.core import config as jax_config
from perceiver_io_tpu.models.text import classifier as jax_classifier
from perceiver_io_tpu.models.text import common as jax_common
from perceiver_io_tpu.models.text import mlm as jax_mlm
from perceiver_io_tpu.scripts import cli as jax_cli
from perceiver_io_tpu.scripts.text import classifier as jax_script
from perceiver_io_tpu.training import checkpoint as jax_checkpoint
from perceiver_io_tpu.training import tasks as jax_tasks
from perceiver_io_tpu_torch.convert.from_jax import load_jax_params, state_dict_from_jax
from perceiver_io_tpu_torch.data.text.preprocessor import TextPreprocessor
from perceiver_io_tpu_torch.data.text.tokenizers import ByteTokenizer
from perceiver_io_tpu_torch.inference.pipelines import pipeline, pipeline_from_pretrained
from perceiver_io_tpu_torch.models import model_for_config
from perceiver_io_tpu_torch.models.core import config as port_config
from perceiver_io_tpu_torch.models.text import classifier
from perceiver_io_tpu_torch.models.text import common
from perceiver_io_tpu_torch.models.text import mlm
from perceiver_io_tpu_torch.scripts import cli as port_cli
from perceiver_io_tpu_torch.scripts.text import classifier as port_script
from perceiver_io_tpu_torch.training import checkpoint as port_checkpoint
from perceiver_io_tpu_torch.training import tasks

TOL = dict(atol=1e-5, rtol=1e-5)
KEY = jax.random.PRNGKey(0)
VOCAB = 262
SEQ = 32
ENCODER = dict(vocab_size=VOCAB, max_seq_len=SEQ, num_input_channels=16, num_cross_attention_heads=2,
               num_cross_attention_qk_channels=8, num_cross_attention_v_channels=16,
               num_self_attention_heads=2, num_self_attention_layers_per_block=2)
DECODER = dict(num_output_query_channels=12, num_cross_attention_heads=2, num_classes=2)
LATENTS = dict(num_latents=4, num_latent_channels=16)


def _configs(encoder=ENCODER, decoder=DECODER, latents=LATENTS):
    jax_cfg = jax_config.PerceiverIOConfig(jax_common.TextEncoderConfig(**encoder),
                                           jax_config.ClassificationDecoderConfig(**decoder), **latents)
    port_cfg = port_config.PerceiverIOConfig(common.TextEncoderConfig(**encoder),
                                             port_config.ClassificationDecoderConfig(**decoder), **latents)
    return jax_cfg, port_cfg


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _seeded_params(module, *args, seed=0):
    shapes = jax.eval_shape(module.init, KEY, *args)["params"]
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(lambda s: (rng.standard_normal(s.shape) * 0.1).astype(np.float32), shapes)


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
def models():
    """The JAX classifier, its seeded params and the port's model carrying
    the same weights."""
    jax_cfg, port_cfg = _configs()
    model = jax_classifier.TextClassifier(jax_cfg)
    params = _seeded_params(model, jnp.zeros((1, SEQ), jnp.int32))
    port = load_jax_params(classifier.TextClassifier(port_cfg, device="cpu", seed=1), _np(params))
    return model, params, port


def _batch(rng, b=4, n=24):
    ids = rng.integers(0, VOCAB - 6, (b, n)).astype(np.int32)
    pad = np.zeros((b, n), bool)
    pad[1, 17:] = True
    pad[2, 9:] = True
    return ids, pad


def test_logits_match_jax(models, rng):
    model, params, port = models
    ids, pad = _batch(rng)
    want = jax.jit(lambda p, x, m: model.apply({"params": p}, x, pad_mask=m))(params, ids, pad)
    got = port(torch.from_numpy(ids).long(), pad_mask=torch.from_numpy(pad))
    assert got.shape == (4, 2)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    assert {k for k in port.state_dict() if k.startswith("decoder.")} >= {
        "decoder.output_query_provider.query", "decoder.output_adapter.linear.weight",
        "decoder.output_adapter.linear.bias"}


def test_loss_accuracy_and_grads_match_jax(models, rng):
    model, params, port = models
    ids, pad = _batch(rng)
    labels = np.asarray([0, 1, 1, 0], np.int32)
    batch = {"input_ids": ids, "labels": labels, "pad_mask": pad}
    loss_fn = jax_tasks.classifier_loss_fn(model)
    (want, aux), grads = jax.jit(jax.value_and_grad(lambda p: loss_fn(p, batch, None), has_aux=True))(params)
    port.zero_grad()
    loss, metrics = tasks.classifier_loss_fn(port)(
        port, {"input_ids": torch.from_numpy(ids).long(), "labels": torch.from_numpy(labels),
               "pad_mask": torch.from_numpy(pad)}, None)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), **TOL)
    assert sorted(metrics) == ["accuracy"]
    np.testing.assert_allclose(metrics["accuracy"].item(), float(aux["accuracy"]), **TOL)
    want_grads = state_dict_from_jax(_np(grads))
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[name].numpy(), atol=1e-5, rtol=1e-4,
                                   err_msg=name)


def _mlm_configs():
    dec = dict(vocab_size=VOCAB, max_seq_len=SEQ, num_cross_attention_heads=2, cross_attention_residual=False)
    return (jax_config.PerceiverIOConfig(jax_common.TextEncoderConfig(**ENCODER),
                                         jax_mlm.TextDecoderConfig(**dec), **LATENTS),
            port_config.PerceiverIOConfig(common.TextEncoderConfig(**ENCODER),
                                          mlm.TextDecoderConfig(**dec), **LATENTS))


@pytest.fixture(scope="module")
def pretrained_mlm(tmp_path_factory):
    """A masked LM of the classifier's encoder widths: seeded JAX weights
    saved by the JAX package, and the same weights carried to the port by
    ``from_jax`` and saved by the port."""
    root = tmp_path_factory.mktemp("mlm")
    jax_cfg, port_cfg = _mlm_configs()
    params = _seeded_params(jax_mlm.MaskedLanguageModel(jax_cfg), jnp.zeros((1, SEQ), jnp.int32), seed=7)
    jax_checkpoint.save_pretrained(str(root / "jax"), jax.device_get(params), jax_cfg)
    port = load_jax_params(mlm.MaskedLanguageModel(port_cfg, device="cpu"), _np(params))
    port_checkpoint.save_pretrained(str(root / "port"), port, port_cfg)
    return root, params


def test_warm_start_from_a_port_saved_mlm_matches_jax(models, pretrained_mlm, rng):
    root, mlm_params = pretrained_mlm
    model, params, port = models
    jax_cfg, port_cfg = _configs()
    jax_cfg = dataclasses.replace(jax_cfg, encoder=dataclasses.replace(jax_cfg.encoder, params=str(root / "jax")))
    port_cfg = dataclasses.replace(port_cfg, encoder=dataclasses.replace(port_cfg.encoder, params=str(root / "port")))
    # the JAX family's warm start (scripts/text/classifier.py _initial_params), its init jitted
    jax_model = jax_classifier.TextClassifier(jax_cfg)
    warm = dict(jax.jit(jax_model.init)(KEY, jnp.zeros((1, SEQ), jnp.int32))["params"])
    warm["encoder"] = jax_checkpoint.load_subtree(jax_cfg.encoder.params, "encoder", target=warm["encoder"])
    # the encoder subtree is the MLM's
    for a, b in zip(jax.tree_util.tree_leaves(warm["encoder"]), jax.tree_util.tree_leaves(mlm_params["encoder"])):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    fresh = classifier.TextClassifier(port_cfg, device="cpu")
    fresh.decoder.load_state_dict({k[len("decoder."):]: v for k, v in state_dict_from_jax(_np(warm)).items()
                                   if k.startswith("decoder.")})
    port_script._initial_params(fresh, port_cfg, None)
    ids, pad = _batch(rng)
    want = jax.jit(lambda p, x, m: jax_model.apply({"params": p}, x, pad_mask=m))(warm, ids, pad)
    got = fresh(torch.from_numpy(ids).long(), pad_mask=torch.from_numpy(pad))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    port_cfg_none = dataclasses.replace(port_cfg, encoder=dataclasses.replace(port_cfg.encoder, params=None))
    untouched = classifier.TextClassifier(port_cfg_none, device="cpu")
    before = {k: v.clone() for k, v in untouched.state_dict().items()}
    port_script._initial_params(untouched, port_cfg_none, None)  # no params: nothing loads
    assert all(torch.equal(before[k], v) for k, v in untouched.state_dict().items())


# -- the CLI (tests/test_cli_families.py) -------------------------------------------

CLI_FLAGS = [f"--model.encoder.{k}={v}" for k, v in ENCODER.items() if k not in ("vocab_size", "max_seq_len")] + [
    f"--model.decoder.{k}={v}" for k, v in DECODER.items() if k != "num_classes"] + [
    f"--model.{k}={v}" for k, v in LATENTS.items()] + [
    "--data=synthetic", f"--data.max_seq_len={SEQ}", "--data.batch_size=4", "--data.num_train_docs=8",
    "--data.num_valid_docs=4", "--data.doc_chars=96", "--optimizer.lr=1e-2", "--lr_scheduler.warmup_steps=1",
    "--trainer.max_steps=3", "--trainer.val_check_interval=3", "--trainer.log_every_n_steps=1",
    "--trainer.enable_checkpointing=false", "--trainer.enable_tensorboard=false",
    "--trainer.limit_val_batches=1", "--trainer.limit_test_batches=1"]


@pytest.fixture(scope="module")
def cli_runs(pretrained_mlm, tmp_path_factory):
    """Both CLIs' two-stage ``fit`` (frozen, then unfrozen) and ``validate``
    / ``test`` from the same weights: the decoder from JAX's warm-start init
    (``PRNGKey(0)``), the encoder from the saved MLM."""
    root, _ = pretrained_mlm
    tmp = tmp_path_factory.mktemp("cli")
    jax_cfg, _ = _configs(dict(ENCODER, params=str(root / "jax")))
    jax_init = jax_classifier.TextClassifier(jax_cfg).init(KEY, jnp.zeros((1, SEQ), jnp.int32))["params"]
    port_family = dataclasses.replace(
        port_script.FAMILY,
        build_model=lambda cfg, dm, **kw: load_jax_params(classifier.TextClassifier(cfg, **kw), _np(jax_init)))
    runs = {"mlm_dir": root / "port"}
    for name, main, extra, mlm_dir in (
            ("jax", jax_cli.CLI(jax_script.FAMILY).main, ["--mesh.data=1"], root / "jax"),
            ("port", port_cli.CLI(port_family).main, ["--device=cpu"], root / "port")):
        argv = [*CLI_FLAGS, f"--data.dataset_dir={tmp / 'data'}", *extra, f"--model.encoder.params={mlm_dir}"]
        for stage, freeze in (("frozen", "true"), ("unfrozen", "false")):
            out = tmp / f"{name}_{stage}"
            state = main(["fit", *argv, f"--model.encoder.freeze={freeze}", f"--trainer.default_root_dir={out}"])
            rows = [json.loads(line) for line in open(out / "metrics.jsonl")]
            runs[(name, stage)] = (state, {key: [(r["step"], r[key]) for r in rows if key in r]
                                           for key in ("train/loss", "val/loss")})
        for sub in ("validate", "test"):
            runs[(name, sub)] = main([sub, *argv, f"--trainer.default_root_dir={tmp / (name + sub)}"])
    return runs


@pytest.mark.parametrize("stage", ["frozen", "unfrozen"])
def test_cli_two_stage_fit_matches_jax(cli_runs, stage):
    for key in ("train/loss", "val/loss"):
        got, want = cli_runs[("port", stage)][1][key], cli_runs[("jax", stage)][1][key]
        assert got and [s for s, _ in got] == [s for s, _ in want], key
        np.testing.assert_allclose([v for _, v in got], [v for _, v in want], rtol=1e-5, err_msg=key)
    state = cli_runs[("port", stage)][0]
    assert state.step == 3
    mlm_encoder = port_checkpoint.load_subtree(str(cli_runs["mlm_dir"]), "encoder")
    encoder = state.model.encoder.state_dict()
    equal = all(torch.equal(encoder[k], v) for k, v in mlm_encoder.items())
    assert equal == (stage == "frozen")  # frozen: bit-identical; unfrozen: trained
    # the frozen stage leaves the encoder out of the optimizer: only decoder parameters
    trained = {id(p) for group in state.optimizer.param_groups for p in group["params"]}
    names = {n for n, p in state.model.named_parameters() if id(p) in trained}
    assert names and all(n.startswith("decoder.") for n in names) == (stage == "frozen")


def test_cli_validate_and_test_match_jax(cli_runs):
    for sub in ("validate", "test"):
        got, want = cli_runs[("port", sub)], cli_runs[("jax", sub)]
        assert sorted(got) == sorted(want) and "accuracy" in "".join(got)
        for key, value in want.items():
            np.testing.assert_allclose(got[key], float(value), rtol=1e-5, err_msg=key)


def test_cli_parses_the_reference_defaults():
    """The classifier CLI's paper defaults (256 latents of 1280 channels, one
    output query of 1280 channels) build equal configs in both packages; both
    list the same flags, data modules and frozen prefixes."""
    assert port_script.FAMILY.defaults == jax_script.FAMILY.defaults
    values = {k: v for k, v in port_script.FAMILY.defaults.items() if k.startswith("model.")}
    values["model.encoder.freeze"] = True
    cfgs = [cli.build_dataclass(family.config_class, values, "model", family.nested)
            for cli, family in ((port_cli, port_script.FAMILY), (jax_cli, jax_script.FAMILY))]
    assert port_config.config_to_dict(cfgs[0]) == jax_config.config_to_dict(cfgs[1])
    assert (cfgs[0].num_latents, cfgs[0].num_latent_channels) == (256, 1280)
    assert cfgs[0].decoder.num_output_query_channels == 1280
    assert port_script.FAMILY.frozen_prefixes(cfgs[0]) == jax_script.FAMILY.frozen_prefixes(cfgs[1]) == ("encoder",)
    assert (port_cli.flag_specs(port_script.FAMILY.config_class, "model", port_script.FAMILY.nested).keys()
            == jax_cli.flag_specs(jax_script.FAMILY.config_class, "model", jax_script.FAMILY.nested).keys())
    assert sorted(port_script.DATA) == sorted(jax_script.DATA)


# -- pipelines and pretrained dirs (tests/test_pipelines.py) ----------------------------

TEXTS = ["a great film", "dull and far too long, the worst of the year", "x"]


@pytest.mark.parametrize("task", ["sentiment-analysis", "text-classification"])
def test_pipeline_labels_and_scores_match_jax(models, task):
    model, params, port = models
    want = jax_pipeline(task, model, params, JaxPreprocessor(JaxByteTokenizer(), max_seq_len=SEQ))(TEXTS)
    pipe = pipeline(task, port, TextPreprocessor(ByteTokenizer(), max_seq_len=SEQ), device="cpu")
    got = pipe(TEXTS)
    assert [r["label"] for r in got] == [r["label"] for r in want]
    np.testing.assert_allclose([r["score"] for r in got], [r["score"] for r in want], **TOL)
    assert pipe("a great film") == got[:1]
    relabelled = pipeline(task, port, TextPreprocessor(ByteTokenizer(), max_seq_len=SEQ), ("neg", "pos"),
                          device="cpu")(TEXTS)
    assert [r["label"] for r in relabelled] == [{"NEGATIVE": "neg", "POSITIVE": "pos"}[r["label"]] for r in got]


def test_config_round_trips_and_serves_from_pretrained(models, tmp_path):
    jax_cfg, port_cfg = _configs()
    assert port_config.config_to_dict(port_cfg) == jax_config.config_to_dict(jax_cfg)
    assert port_config.config_from_dict(None, jax_config.config_to_dict(jax_cfg)) == port_cfg
    _, _, port = models
    port_checkpoint.save_pretrained(str(tmp_path), port, port_cfg)
    assert port_checkpoint.load_config(str(tmp_path)) == port_cfg
    assert isinstance(model_for_config(port_cfg, device="cpu"), classifier.TextClassifier)
    prep = TextPreprocessor(ByteTokenizer(), max_seq_len=SEQ)
    served = pipeline_from_pretrained("sentiment-analysis", str(tmp_path), prep, device="cpu")(TEXTS)
    assert served == pipeline("sentiment-analysis", port, prep, device="cpu")(TEXTS)


def test_published_width_parameter_count():
    widths = dict(num_input_channels=768, num_cross_attention_heads=8, num_cross_attention_qk_channels=256,
                  num_cross_attention_v_channels=1280, num_self_attention_heads=8,
                  num_self_attention_qk_channels=256, num_self_attention_v_channels=1280,
                  num_self_attention_layers_per_block=26, vocab_size=VOCAB, max_seq_len=2048)
    jax_cfg, port_cfg = _configs(widths, dict(num_output_query_channels=1280, num_cross_attention_heads=8,
                                              num_classes=2), dict(num_latents=256, num_latent_channels=1280))
    shapes = jax.eval_shape(jax_classifier.TextClassifier(jax_cfg).init, KEY, jnp.zeros((1, 2048), jnp.int32))
    with torch.device("meta"):
        modules = (common.make_text_encoder(port_cfg.encoder, 256, 1280),
                   classifier.classification_decoder(port_cfg, torch.float32, "auto"))
    port_count = sum(p.numel() for m in modules for p in m.parameters())
    assert port_count == sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(shapes)) == 206_098_690
    # at the JAX CLI's defaults (the encoder's channels unset: 64 input channels, 8 self-attends)
    jax_cfg, port_cfg = _configs(dict(vocab_size=VOCAB, max_seq_len=2048),
                                 dict(num_output_query_channels=1280, num_classes=2),
                                 dict(num_latents=256, num_latent_channels=1280))
    shapes = jax.eval_shape(jax_classifier.TextClassifier(jax_cfg).init, KEY, jnp.zeros((1, 2048), jnp.int32))
    with torch.device("meta"):
        modules = (common.make_text_encoder(port_cfg.encoder, 256, 1280),
                   classifier.classification_decoder(port_cfg, torch.float32, "auto"))
    port_count = sum(p.numel() for m in modules for p in m.parameters())
    assert port_count == sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(shapes)) == 95_801_090
