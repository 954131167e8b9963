"""The Perceiver IO encoder/decoder and the masked LM of the port against the
JAX package, on the CPU.

- **Encoder / decoder** (mirrors ``tests/test_core_modules.py``): the
  weight-sharing variants, pad masks, the non-residual decoder, the
  classification head and remat equivalence, each from the same seeded JAX
  weights carried over by ``convert/from_jax.py``, at atol/rtol 1e-5 in
  fp32. Every attention layer has q/k channels unlike its v channels, so the
  plain attention path runs ``dv != d``.
- **Masked LM** (mirrors ``tests/test_task_models.py``): tied and untied
  logits with a pad mask, ``mlm_loss_fn``'s loss and gradients against
  ``jax.grad``, config dicts equal across the packages, and a
  ``save_pretrained`` dir served through ``pipeline_from_pretrained``.
- **Fill-mask** (mirrors ``tests/test_pipelines.py``): the filled strings
  equal JAX's.
- **CLI** (mirrors ``tests/test_cli_families.py``'s MLM case): both CLIs'
  ``fit`` from the same weights log the same losses, and ``validate`` /
  ``test`` give the same metrics, at 1e-5 relative.
- **K1-K3's plain versions at the masked LM's (d, dv) pairs** (32, 96) and
  (32, 160), non-causal, with and without a pad mask (a batch row with every
  key padded: dead rows), against JAX's Pallas kernels in interpret mode and
  ``jax.grad`` of them, at the JAX kernel tests' tolerance (1e-4).

One tiny config (vocab 262, 32 positions, 16 input channels, 4 latents of
16 channels, 2 heads of q/k 4 and v 8 in the encoder, q/k 8 in the
decoder), weights drawn from a seeded numpy generator into the JAX tree's
shapes, and shared JAX models per module.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from perceiver_io_tpu.data.text.preprocessor import TextPreprocessor as JaxPreprocessor
from perceiver_io_tpu.data.text.tokenizers import ByteTokenizer as JaxByteTokenizer
from perceiver_io_tpu.inference import pipeline as jax_pipeline
from perceiver_io_tpu.models.core import adapter as jax_adapter
from perceiver_io_tpu.models.core import config as jax_config
from perceiver_io_tpu.models.core import modules as jax_modules
from perceiver_io_tpu.models.text import common as jax_common
from perceiver_io_tpu.models.text import mlm as jax_mlm
from perceiver_io_tpu.ops import flash_attention as jax_flash
from perceiver_io_tpu.scripts import cli as jax_cli
from perceiver_io_tpu.scripts.text import mlm as jax_mlm_script
from perceiver_io_tpu.training import checkpoint as jax_checkpoint
from perceiver_io_tpu.training import tasks as jax_tasks
from perceiver_io_tpu_torch.convert.from_jax import load_jax_params, state_dict_from_jax
from perceiver_io_tpu_torch.data.text.preprocessor import TextPreprocessor
from perceiver_io_tpu_torch.data.text.tokenizers import ByteTokenizer
from perceiver_io_tpu_torch.inference.pipelines import pipeline, pipeline_from_pretrained
from perceiver_io_tpu_torch.models import model_for_config
from perceiver_io_tpu_torch.models.core import adapter
from perceiver_io_tpu_torch.models.core import config as port_config
from perceiver_io_tpu_torch.models.core import modules
from perceiver_io_tpu_torch.models.text import common
from perceiver_io_tpu_torch.models.text import mlm
from perceiver_io_tpu_torch.ops import attention
from perceiver_io_tpu_torch.ops import flash_attention as flash
from perceiver_io_tpu_torch.scripts import cli as port_cli
from perceiver_io_tpu_torch.scripts.text import mlm as port_mlm_script
from perceiver_io_tpu_torch.training import checkpoint as port_checkpoint
from perceiver_io_tpu_torch.training import tasks

TOL = dict(atol=1e-5, rtol=1e-5)
KERNEL_TOL = dict(atol=1e-4, rtol=1e-4)  # tests/test_flash_attention.py's
KEY = jax.random.PRNGKey(0)
VOCAB = 262
ENCODER = dict(vocab_size=VOCAB, max_seq_len=32, num_input_channels=16, num_cross_attention_heads=2,
               num_cross_attention_qk_channels=8, num_cross_attention_v_channels=16,
               num_self_attention_heads=2, num_self_attention_qk_channels=8,
               num_self_attention_v_channels=16, num_self_attention_layers_per_block=2)
LATENTS = dict(num_latents=4, num_latent_channels=16)


def _decoder(tied: bool) -> dict:
    return dict(vocab_size=VOCAB, max_seq_len=32, num_output_query_channels=None if tied else 12,
                num_cross_attention_heads=2, num_cross_attention_qk_channels=8,
                cross_attention_residual=False)


def _configs(tied: bool):
    jax_cfg = jax_config.PerceiverIOConfig(jax_common.TextEncoderConfig(**ENCODER),
                                           jax_mlm.TextDecoderConfig(**_decoder(tied)), **LATENTS)
    port_cfg = port_config.PerceiverIOConfig(common.TextEncoderConfig(**ENCODER),
                                             mlm.TextDecoderConfig(**_decoder(tied)), **LATENTS)
    return jax_cfg, port_cfg


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _seeded_params(module, *args, seed=0):
    """``module``'s JAX param tree with every weight drawn from a seeded
    numpy generator (``eval_shape`` gives the tree without compiling
    ``init``)."""
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
def mlms():
    """Per tied/untied: the JAX model, its seeded params and the port's
    model carrying the same weights."""
    out = {}
    for tied in (True, False):
        jax_cfg, port_cfg = _configs(tied)
        model = jax_mlm.MaskedLanguageModel(jax_cfg)
        params = _seeded_params(model, jnp.zeros((1, 32), jnp.int32))
        port = load_jax_params(mlm.MaskedLanguageModel(port_cfg, device="cpu", seed=1), _np(params))
        out[tied] = (model, params, port)
    return out


def _batch(rng, b=3, n=24):
    ids = rng.integers(0, VOCAB - 6, (b, n)).astype(np.int32)
    pad = np.zeros((b, n), bool)
    pad[1, 17:] = True
    pad[2, 9:] = True
    return ids, pad


# -- encoder / decoder (tests/test_core_modules.py) ------------------------------


class JaxDenseAdapter(jax_adapter.InputAdapter):
    channels: int = 12

    @property
    def num_input_channels(self):
        return self.channels

    @jax_modules.nn.compact
    def __call__(self, x):
        return jax_modules.nn.Dense(self.channels, name="proj")(x)


class DenseAdapter(adapter.InputAdapter):
    def __init__(self, channels: int = 12):
        super().__init__()
        self.proj = nn.Linear(4, channels)

    @property
    def num_input_channels(self):
        return self.proj.out_features

    def forward(self, x):
        return self.proj(x)


ENCODER_KW = dict(num_latents=8, num_latent_channels=16, num_cross_attention_heads=2,
                  num_cross_attention_qk_channels=8, num_cross_attention_v_channels=16,
                  num_self_attention_heads=2, num_self_attention_qk_channels=8,
                  num_self_attention_v_channels=16, num_self_attention_layers_per_block=2)
# (cross layers, self blocks, first cross shared, first self block shared)
SHARING = [(1, 1, False, True), (2, 2, True, True), (2, 2, False, False), (2, 3, False, True)]


def _encoders(layers, blocks, cross_shared, self_shared, **kw):
    shared = dict(num_cross_attention_layers=layers, num_self_attention_blocks=blocks,
                  first_cross_attention_layer_shared=cross_shared,
                  first_self_attention_block_shared=self_shared, **ENCODER_KW, **kw)
    return (jax_modules.PerceiverEncoder(input_adapter=JaxDenseAdapter(), **shared),
            modules.PerceiverEncoder(DenseAdapter(), **shared))


def _port_module(module, params):
    module.load_state_dict(state_dict_from_jax(_np(params)), strict=True)
    return module


@pytest.mark.parametrize("layers,blocks,cross_shared,self_shared", SHARING)
def test_encoder_matches_jax(rng, layers, blocks, cross_shared, self_shared):
    jax_enc, port_enc = _encoders(layers, blocks, cross_shared, self_shared)
    x = rng.standard_normal((2, 10, 4)).astype(np.float32)
    pad = np.zeros((2, 10), bool)
    pad[1, 6:] = True
    params = _seeded_params(jax_enc, jnp.asarray(x))
    # one parameter set per shared layer, in both trees
    assert ("cross_attn_n" in params) == (layers > 1 and not cross_shared)
    assert ("self_attn_n" in params) == (blocks > 1 and not self_shared)
    _port_module(port_enc, params)
    assert sum(p.numel() for p in port_enc.parameters()) == sum(
        np.prod(p.shape) for p in jax.tree_util.tree_leaves(params))
    want = jax.jit(lambda p, x, m: jax_enc.apply({"params": p}, x, pad_mask=m))(params, x, pad)
    latents, adapted = port_enc(torch.from_numpy(x), pad_mask=torch.from_numpy(pad), return_adapted_input=True)
    np.testing.assert_allclose(latents.detach().numpy(), np.asarray(want), **TOL)
    assert latents.shape == (2, 8, 16) and adapted.shape == (2, 10, 12)
    # padded inputs change nothing
    x2 = x.copy()
    x2[1, 6:] += 100.0
    again = port_enc(torch.from_numpy(x2), pad_mask=torch.from_numpy(pad))
    np.testing.assert_allclose(again.detach().numpy(), latents.detach().numpy(), atol=1e-5)


def test_encoder_config_validation():
    # JAX raises at init, the port at construction
    for layers, blocks in ((0, 1), (3, 2)):
        with pytest.raises(ValueError, match="num_cross_attention_layers must be"):
            modules.PerceiverEncoder(DenseAdapter(), **{**ENCODER_KW, "num_cross_attention_layers": layers,
                                                        "num_self_attention_blocks": blocks})
    with pytest.raises(ValueError, match="num_v_channels must be divisible"):
        modules.MultiHeadAttention(2, 16, 16, num_v_channels=15)


def test_encoder_remat_matches_plain_and_jax_grads(rng):
    jax_enc, port_enc = _encoders(2, 2, False, True)
    _, port_remat = _encoders(2, 2, False, True, activation_checkpointing=True)
    x = rng.standard_normal((2, 10, 4)).astype(np.float32)
    params = _seeded_params(jax_enc, jnp.asarray(x))
    grads = {}
    for name, enc in (("plain", port_enc), ("remat", port_remat)):
        _port_module(enc, params)
        out = enc(torch.from_numpy(x))
        (out ** 2).sum().backward()
        grads[name] = {k: p.grad.numpy() for k, p in enc.named_parameters()}
    want = state_dict_from_jax(_np(jax.jit(jax.grad(
        lambda p: jnp.sum(jax_enc.apply({"params": p}, jnp.asarray(x)) ** 2)))(params)))
    for key, g in grads["plain"].items():
        np.testing.assert_allclose(grads["remat"][key], g, atol=1e-6, err_msg=key)
        np.testing.assert_allclose(g, want[key].numpy(), atol=1e-5, rtol=1e-5, err_msg=key)


@pytest.mark.parametrize("residual,queries", [(True, 1), (False, 4)])
def test_decoder_matches_jax(rng, residual, queries):
    kw = dict(num_latent_channels=16, num_output_query_channels=16, num_cross_attention_heads=2,
              num_cross_attention_qk_channels=8, cross_attention_residual=residual)
    jax_dec = jax_modules.PerceiverDecoder(
        output_adapter=jax_adapter.ClassificationOutputAdapter(num_classes=5, num_output_query_channels=16),
        output_query_provider=jax_adapter.TrainableQueryProvider(num_queries=queries, num_query_channels_=16),
        **kw)
    port_dec = modules.PerceiverDecoder(adapter.ClassificationOutputAdapter(5, 16),
                                        adapter.TrainableQueryProvider(queries, 16), **kw)
    lat = rng.standard_normal((3, 8, 16)).astype(np.float32)
    params = _seeded_params(jax_dec, jnp.asarray(lat))
    _port_module(port_dec, params)
    want = jax.jit(lambda p, x: jax_dec.apply({"params": p}, x))(params, lat)
    got = port_dec(torch.from_numpy(lat))
    assert got.shape == ((3, 5) if queries == 1 else (3, queries, 5))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def test_perceiver_io_end_to_end(rng):
    jax_enc, port_enc = _encoders(1, 1, False, True)
    kw = dict(num_latent_channels=16, num_output_query_channels=16, num_cross_attention_heads=2)
    jax_io = jax_modules.PerceiverIO(
        encoder=jax_enc, decoder=jax_modules.PerceiverDecoder(
            output_adapter=jax_adapter.ClassificationOutputAdapter(num_classes=3, num_output_query_channels=16),
            output_query_provider=jax_adapter.TrainableQueryProvider(num_queries=1, num_query_channels_=16),
            **kw))
    port_io = modules.PerceiverIO(port_enc, modules.PerceiverDecoder(
        adapter.ClassificationOutputAdapter(3, 16), adapter.TrainableQueryProvider(1, 16), **kw))
    x = rng.standard_normal((2, 10, 4)).astype(np.float32)
    params = _seeded_params(jax_io, jnp.asarray(x))
    _port_module(port_io, params)
    want = jax.jit(lambda p, x: jax_io.apply({"params": p}, x))(params, x)
    np.testing.assert_allclose(port_io(torch.from_numpy(x)).detach().numpy(), np.asarray(want), **TOL)


# -- the masked LM (tests/test_task_models.py) -------------------------------------


@pytest.mark.parametrize("tied", [True, False])
def test_mlm_logits_match_jax(mlms, rng, tied):
    model, params, port = mlms[tied]
    ids, pad = _batch(rng)
    want = jax.jit(lambda p, x, m: model.apply({"params": p}, x, pad_mask=m))(params, ids, pad)
    got = port(torch.from_numpy(ids).long(), pad_mask=torch.from_numpy(pad))
    assert got.shape == (3, 24, VOCAB)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    names = [k for k in port.state_dict() if k.startswith("decoder.output_adapter")]
    assert names == (["decoder.output_adapter.bias"] if tied else
                     ["decoder.output_adapter.linear.weight", "decoder.output_adapter.linear.bias"])


@pytest.mark.parametrize("tied", [True, False])
def test_mlm_loss_and_grads_match_jax(mlms, rng, tied):
    model, params, port = mlms[tied]
    ids, pad = _batch(rng)
    labels = np.where(rng.random(ids.shape) < 0.3, ids, tasks.IGNORE_INDEX).astype(np.int32)
    batch = {"input_ids": ids, "labels": labels, "pad_mask": pad}
    loss_fn = jax_tasks.mlm_loss_fn(model)
    (want, _), grads = jax.jit(jax.value_and_grad(lambda p: loss_fn(p, batch, None), has_aux=True))(params)
    port.zero_grad()
    loss, metrics = tasks.mlm_loss_fn(port)(port, {k: torch.from_numpy(v).long() if v.dtype != bool
                                                   else torch.from_numpy(v) for k, v in batch.items()}, None)
    loss.backward()
    assert metrics == {}
    np.testing.assert_allclose(loss.item(), float(want), **TOL)
    want_grads = state_dict_from_jax(_np(grads))
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[name].numpy(), atol=1e-5, rtol=1e-4,
                                   err_msg=name)


def test_text_input_adapter_refuses_long_inputs():
    adapt = common.TextInputAdapter(VOCAB, 8, 16)
    with pytest.raises(ValueError, match="exceeds max_seq_len"):
        adapt(torch.zeros(1, 9, dtype=torch.long))


@pytest.mark.parametrize("tied", [True, False])
def test_mlm_config_round_trips_and_serves_from_pretrained(mlms, tmp_path, tied):
    jax_cfg, port_cfg = _configs(tied)
    assert port_config.config_to_dict(port_cfg) == jax_config.config_to_dict(jax_cfg)
    assert port_config.config_from_dict(None, jax_config.config_to_dict(jax_cfg)) == port_cfg
    _, _, port = mlms[tied]
    port_checkpoint.save_pretrained(str(tmp_path), port, port_cfg)
    assert port_checkpoint.load_config(str(tmp_path)) == port_cfg
    assert isinstance(model_for_config(port_cfg, device="cpu"), mlm.MaskedLanguageModel)
    prep = TextPreprocessor(ByteTokenizer(), max_seq_len=32)
    pipe = pipeline_from_pretrained("fill-mask", str(tmp_path), prep, device="cpu")
    direct = pipeline("fill-mask", port, prep, device="cpu")
    assert pipe(["a<mask>c", "the <mask>at"], top_k=3) == direct(["a<mask>c", "the <mask>at"], top_k=3)


def test_fill_mask_matches_jax(mlms):
    model, params, port = mlms[True]
    texts = ["a<mask>c", "the c<mask>t sat on the <mask>at", "<mask><mask>llo"]
    want = jax_pipeline("fill-mask", model, params, JaxPreprocessor(JaxByteTokenizer(), max_seq_len=32))(
        texts, top_k=4)
    got = pipeline("fill-mask", port, TextPreprocessor(ByteTokenizer(), max_seq_len=32), device="cpu")(
        texts, top_k=4)
    assert got == want and len(got) == 3 and all(len(f) == 4 for f in got)


def test_mask_filling_callback_logs_fillings(mlms):
    from perceiver_io_tpu_torch.training.callbacks import MaskFillingCallback

    _, _, port = mlms[True]
    logged = []

    class Trainer:
        def log_text(self, step, tag, text):
            logged.append((step, tag, text))

    prep = TextPreprocessor(ByteTokenizer(), max_seq_len=32)
    MaskFillingCallback(port, prep, ["a<mask>c"], top_k=2)(Trainer(), None, 7, {})
    fillings = pipeline("fill-mask", port, prep, device="cpu")("a<mask>c", top_k=2)[0]
    assert logged == [(7, "samples/fill_mask", f"'a<mask>c' -> {fillings}")]


# -- the CLI (tests/test_cli_families.py) -------------------------------------------

CLI_MODEL = {"encoder.num_input_channels": 16, "encoder.num_cross_attention_heads": 2,
             "encoder.num_cross_attention_qk_channels": 8, "encoder.num_cross_attention_v_channels": 16,
             "encoder.num_self_attention_heads": 2, "encoder.num_self_attention_qk_channels": 8,
             "encoder.num_self_attention_v_channels": 16, "encoder.num_self_attention_layers_per_block": 1,
             "decoder.num_cross_attention_heads": 2, "decoder.num_cross_attention_qk_channels": 8,
             "decoder.cross_attention_residual": False, "num_latents": 4, "num_latent_channels": 16}
CLI_FLAGS = [f"--model.{k}={str(v).lower() if isinstance(v, bool) else v}" for k, v in CLI_MODEL.items()] + [
    "--data=synthetic", "--data.max_seq_len=64", "--data.batch_size=8", "--data.num_train_docs=4",
    "--data.num_valid_docs=2", "--data.doc_chars=256", "--optimizer.lr=1e-3",
    "--lr_scheduler.warmup_steps=1", "--trainer.max_steps=3", "--trainer.val_check_interval=3",
    "--trainer.log_every_n_steps=1", "--trainer.enable_checkpointing=false",
    "--trainer.enable_tensorboard=false", "--trainer.limit_val_batches=1", "--trainer.limit_test_batches=1"]


def test_cli_fit_validate_test_match_jax(tmp_path):
    """Both MLM CLIs (fp32) from the same weights: fit's logged losses and
    validate/test's metrics agree at 1e-5 relative."""
    enc = {k.split(".", 1)[1]: v for k, v in CLI_MODEL.items() if k.startswith("encoder.")}
    dec = {k.split(".", 1)[1]: v for k, v in CLI_MODEL.items() if k.startswith("decoder.")}
    shape = dict(vocab_size=VOCAB, max_seq_len=64)
    jax_cfg = jax_config.PerceiverIOConfig(jax_common.TextEncoderConfig(**enc, **shape),
                                           jax_mlm.TextDecoderConfig(**dec, **shape), num_latents=4,
                                           num_latent_channels=16)
    port_cfg = port_config.PerceiverIOConfig(common.TextEncoderConfig(**enc, **shape),
                                             mlm.TextDecoderConfig(**dec, **shape), num_latents=4,
                                             num_latent_channels=16)
    params = _seeded_params(jax_mlm.MaskedLanguageModel(jax_cfg), jnp.zeros((1, 64), jnp.int32))
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    jax_checkpoint.save_pretrained(str(jax_dir), jax.device_get(params), jax_cfg)
    port = load_jax_params(mlm.MaskedLanguageModel(port_cfg, device="cpu"), _np(params))
    port_checkpoint.save_pretrained(str(port_dir), port, port_cfg)
    jax_family = dataclasses.replace(jax_mlm_script.FAMILY,
                                     build_model=lambda cfg, dm: jax_mlm.MaskedLanguageModel(cfg))
    port_family = dataclasses.replace(port_mlm_script.FAMILY,
                                      build_model=lambda cfg, dm, **kw: mlm.MaskedLanguageModel(cfg, **kw))
    argv = [*CLI_FLAGS, f"--data.dataset_dir={tmp_path / 'data'}"]
    runs = {}
    for name, main, extra, ckpt in (("jax", jax_cli.CLI(jax_family).main, ["--mesh.data=1"], jax_dir),
                                    ("port", port_cli.CLI(port_family).main, ["--device=cpu"], port_dir)):
        root = tmp_path / f"{name}_fit"
        runs[name] = main(["fit", *argv, *extra, f"--params={ckpt}", f"--trainer.default_root_dir={root}"])
        rows = [json.loads(line) for line in open(root / "metrics.jsonl")]
        runs[f"{name}_losses"] = {key: [(r["step"], r[key]) for r in rows if key in r]
                                  for key in ("train/loss", "val/loss")}
        for sub in ("validate", "test"):
            runs[f"{name}_{sub}"] = main([sub, *argv, *extra, f"--ckpt={ckpt}",
                                          f"--trainer.default_root_dir={tmp_path / (name + sub)}"])
    assert runs["port"].step == 3
    for key in ("train/loss", "val/loss"):
        got, want = runs["port_losses"][key], runs["jax_losses"][key]
        assert got and [s for s, _ in got] == [s for s, _ in want], key
        np.testing.assert_allclose([v for _, v in got], [v for _, v in want], rtol=1e-5, err_msg=key)
    for sub in ("validate", "test"):
        assert sorted(runs[f"port_{sub}"]) == sorted(runs[f"jax_{sub}"])
        for key, value in runs[f"jax_{sub}"].items():
            np.testing.assert_allclose(runs[f"port_{sub}"][key], float(value), rtol=1e-5, err_msg=key)


def test_cli_parses_the_reference_defaults():
    """The MLM CLI's paper defaults (256 latents of 1280 channels) and a
    published-width flag build equal configs in both packages; both list the
    same flags and data modules."""
    values = {f"model.{k.split('.', 1)[1]}": v for k, v in port_mlm_script.FAMILY.defaults.items()
              if k.startswith("model.")}
    values["model.encoder.num_cross_attention_qk_channels"] = 256
    assert port_mlm_script.FAMILY.defaults == jax_mlm_script.FAMILY.defaults
    cfgs = [cli.build_dataclass(family.config_class, values, "model", family.nested)
            for cli, family in ((port_cli, port_mlm_script.FAMILY), (jax_cli, jax_mlm_script.FAMILY))]
    assert port_config.config_to_dict(cfgs[0]) == jax_config.config_to_dict(cfgs[1])
    assert (cfgs[0].num_latents, cfgs[0].num_latent_channels) == (256, 1280)
    assert cfgs[0].encoder.num_cross_attention_qk_channels == 256
    assert (port_cli.flag_specs(port_mlm_script.FAMILY.config_class, "model", port_mlm_script.FAMILY.nested).keys()
            == jax_cli.flag_specs(jax_mlm_script.FAMILY.config_class, "model", jax_mlm_script.FAMILY.nested).keys())
    assert sorted(port_mlm_script.DATA) == sorted(jax_mlm_script.DATA)


# -- K1-K3's plain versions at the masked LM's (d, dv) pairs ---------------------------


def _qkv(rng, b, i, j, d, dv):
    q = rng.standard_normal((b, 2, i, d)).astype(np.float32) * d**-0.5
    k = rng.standard_normal((b, 2, j, d)).astype(np.float32)
    v = rng.standard_normal((b, 2, j, dv)).astype(np.float32)
    cot = rng.standard_normal((b, 2, i, dv)).astype(np.float32)
    return q, k, v, cot


@pytest.mark.parametrize("dv", [96, 160])
@pytest.mark.parametrize("with_pad", [False, True])
def test_flash_plain_versions_match_pallas_at_mlm_head_dims(rng, dv, with_pad):
    i, j = 128, 256
    q, k, v, cot = _qkv(rng, 2, i, j, 32, dv)
    pad = None
    if with_pad:
        pad = np.zeros((2, j), bool)
        pad[0, 200:] = True
        pad[1, :] = True  # every key padded: batch row 1's rows are all dead

    def jax_out(q, k, v):
        return jax_flash.flash_attention(q, k, v, pad_mask=None if pad is None else jnp.asarray(pad), causal=False)

    want = jax.jit(jax_out)(q, k, v)
    want_grads = jax.jit(jax.grad(lambda q, k, v: jnp.sum(jax_out(q, k, v) * cot), argnums=(0, 1, 2)))(q, k, v)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    tpad = None if pad is None else torch.from_numpy(pad)
    o = flash.flash_attention(tq, tk, tv, pad_mask=tpad, causal=False)
    o.backward(torch.from_numpy(cot))
    assert o.shape == (2, 2, i, dv)
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(want), **KERNEL_TOL)
    for got, ref, name in zip((tq.grad, tk.grad, tv.grad), want_grads, "qkv"):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), err_msg=f"d{name}", **KERNEL_TOL)
    if with_pad:
        # dead rows: o and dq exactly 0 in both packages; padded keys: dk, dv 0
        assert (o[1] == 0).all() and not np.asarray(want)[1].any()
        assert (tq.grad[1] == 0).all() and (tk.grad[:, :, 200:][0] == 0).all() and (tv.grad[1] == 0).all()
    # the wrappers' K2/K3 plain versions give the autograd Function's grads
    # (to fp32 rounding: the CPU's matmuls may split their sums differently
    # from one call to the next under load)
    o2, lse = flash.flash_attention_fwd(*(t.detach() for t in (tq, tk, tv)), pad_mask=tpad)
    dq, dk, dvv = flash.flash_attention_backward_reference(
        tq.detach(), tk.detach(), tv.detach(), o2, lse, torch.from_numpy(cot), pad_mask=tpad)
    for got, ref in zip((dq, dk, dvv), (tq.grad, tk.grad, tv.grad)):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-6, atol=1e-6)


def test_kernel_takes_the_mlm_attends():
    """On CUDA tensors ``auto`` sends the masked LM's three attends at
    language-perceiver width to K1 (the dispatch is a pure function of
    shapes; no card needed)."""
    for dtype in (torch.float32, torch.bfloat16):
        for q, k, v in (((8, 8, 256, 32), (8, 8, 2048, 32), (8, 8, 2048, 160)),
                        ((8, 8, 256, 32), (8, 8, 256, 32), (8, 8, 256, 160)),
                        ((8, 8, 2048, 32), (8, 8, 256, 32), (8, 8, 256, 96))):
            assert attention.kernel_takes(q, k, v, dtype, dtype, dtype, False) is True
    # the JAX CLI defaults' head dims (160, 160): the tile routes' pair
    assert attention.kernel_takes((8, 8, 256, 160), (8, 8, 2048, 160), (8, 8, 2048, 160),
                                  torch.float32, torch.float32, torch.float32, False) is True
    assert flash._fwd_route(256, torch.float32, 160, 160) == "tf32x3"


@pytest.mark.parametrize("route", ["split", "wgmma", "tf32x3", "simt"])
def test_routes_refuse_uninstantiated_pairs_before_their_library_loads(route):
    """A (d, dv) pair a route does not instantiate raises ``ValueError``
    naming the route's pairs before its library loads (there is no ``nvcc``
    here, so a load would raise ``RuntimeError``): the simt kernels take v
    of q's head dim only, and d = 32 nowhere but the three other routes."""
    dtype = torch.float32 if route in ("tf32x3", "split", "simt") else torch.bfloat16
    i = 1 if route == "split" else 64
    pairs = [(112, 96), (32, 32)] if route == "simt" else [(112, 96), (32, 64)]
    for d, dv in pairs:
        q, k = torch.zeros(1, 2, i, d, dtype=dtype), torch.zeros(1, 2, 128, d, dtype=dtype)
        v = torch.zeros(1, 2, 128, dv, dtype=dtype)
        with pytest.raises(ValueError, match=rf"\({d}, {dv}\) are not instantiated by the {route} kernel"):
            flash._fwd_launch(route, q, k, v, None, False)
        if route != "split":
            lse, delta = torch.zeros(1, 2, i), torch.zeros(1, 2, i)
            do = torch.zeros(1, 2, i, dv, dtype=dtype)
            with pytest.raises(ValueError, match=rf"\({d}, {dv}\) are not instantiated by the {route} kernel"):
                flash._bwd_launch(route, q, k, v, lse, delta, do, None, False, 1,
                                  (torch.empty_like(k), torch.empty_like(v)))
    assert route not in flash._FWD and route not in flash._BWD


def test_rotary_frequencies_match_jax(rng):
    shift = rng.integers(0, 5, (3, 1))
    want = jax_adapter.rotary_frequencies((3, 12), 8, abs_pos=jnp.maximum(jnp.arange(12)[None] - shift, 0))
    got = adapter.rotary_frequencies((3, 12), 8, abs_pos=torch.clamp(torch.arange(12)[None] - torch.from_numpy(shift), min=0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(adapter.rotary_frequencies((2, 5), 4).numpy(),
                               np.asarray(jax_adapter.rotary_frequencies((2, 5), 4)), **TOL)
