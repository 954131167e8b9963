"""The Fourier image classifier, its position encoding and the vision data
layer of the port against the JAX package, on the CPU (mirrors the image
cases of ``tests/test_task_models.py``, ``tests/test_data_vision.py``,
``tests/test_pipelines.py``, ``tests/test_cli_families.py`` and
``tests/test_mnist_end_to_end.py``).

- **Fourier table** equal to JAX's at 1e-6, with its channel count and the
  adapter's shape error.
- **Model**: logits, ``image_classifier_loss_fn``'s loss and accuracy, and
  gradients against ``jax.grad``, at 1e-5 (gradients at rtol 1e-4 beside
  atol 1e-5), from the same seeded JAX weights carried over by
  ``convert/from_jax.py`` (8 x 8 x 3 images, 4 bands: q/k 3 + 18 = 21
  channels in one cross head); the q/k default, the config round trip.
- **Data**: ``ImagePreprocessor``, ``ImageNetPreprocessor`` (eval and train
  crops), ``resize_bilinear`` and ``random_crop_and_flip`` array for array;
  the MNIST (``from_arrays``) and synthetic data modules' batches.
- **Pipeline**: ``image-classification`` top-k labels and scores equal
  JAX's; ``pipeline_from_pretrained`` serves a saved model.
- **CLI**: both image CLIs' ``fit`` from the same weights log the same
  losses, and ``validate`` / ``test`` give the same metrics, at 1e-5
  relative.
- **Published width**: at ``deepmind/vision-perceiver-fourier`` width both
  packages count the reference's 48,440,627 parameters (the port's modules
  built on the meta device, JAX's tree through ``eval_shape``).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perceiver_io_tpu.data import vision as jax_vision
from perceiver_io_tpu.inference import pipeline as jax_pipeline
from perceiver_io_tpu.models.core import config as jax_config
from perceiver_io_tpu.models.vision import image_classifier as jax_image
from perceiver_io_tpu.ops import position as jax_position
from perceiver_io_tpu.scripts import cli as jax_cli
from perceiver_io_tpu.scripts.vision import image_classifier as jax_script
from perceiver_io_tpu.training import checkpoint as jax_checkpoint
from perceiver_io_tpu.training import tasks as jax_tasks
from perceiver_io_tpu_torch.convert.from_jax import load_jax_params, state_dict_from_jax
from perceiver_io_tpu_torch.data import vision
from perceiver_io_tpu_torch.inference.pipelines import pipeline, pipeline_from_pretrained
from perceiver_io_tpu_torch.models import model_for_config
from perceiver_io_tpu_torch.models.core import config as port_config
from perceiver_io_tpu_torch.models.vision import image_classifier as image
from perceiver_io_tpu_torch.ops import position
from perceiver_io_tpu_torch.scripts import cli as port_cli
from perceiver_io_tpu_torch.scripts.vision import image_classifier as port_script
from perceiver_io_tpu_torch.training import checkpoint as port_checkpoint
from perceiver_io_tpu_torch.training import tasks

TOL = dict(atol=1e-5, rtol=1e-5)
KEY = jax.random.PRNGKey(0)
SHAPE = (8, 8, 3)
ENCODER = dict(image_shape=SHAPE, num_frequency_bands=4, num_cross_attention_heads=1,
               num_self_attention_heads=2, num_self_attention_layers_per_block=2)
DECODER = dict(num_output_query_channels=12, num_cross_attention_heads=2, num_classes=5)
LATENTS = dict(num_latents=4, num_latent_channels=16)


def _configs(encoder=ENCODER, decoder=DECODER, latents=LATENTS):
    return (jax_config.PerceiverIOConfig(jax_image.ImageEncoderConfig(**encoder),
                                         jax_config.ClassificationDecoderConfig(**decoder), **latents),
            port_config.PerceiverIOConfig(image.ImageEncoderConfig(**encoder),
                                          port_config.ClassificationDecoderConfig(**decoder), **latents))


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
    jax_cfg, port_cfg = _configs()
    model = jax_image.ImageClassifier(jax_cfg)
    params = _seeded_params(model, jnp.zeros((1, *SHAPE), jnp.float32))
    port = load_jax_params(image.ImageClassifier(port_cfg, device="cpu", seed=1), _np(params))
    return model, params, port


@pytest.mark.parametrize("shape,bands", [((8, 8), 4), ((28, 28), 32), ((5,), 3), ((3, 4, 2), 2)])
def test_fourier_table_matches_jax(shape, bands):
    want = jax_position.FourierPositionEncoding(shape, bands)
    got = position.FourierPositionEncoding(shape, bands)
    assert got.num_channels == want.num_channels == len(shape) * (2 * bands + 1)
    np.testing.assert_allclose(got(2).numpy(), np.asarray(want(2)), atol=1e-6, rtol=1e-6)
    assert got(3).shape == (3, int(np.prod(shape)), got.num_channels)
    assert position._fourier_table(tuple(shape), bands) is position._fourier_table(tuple(shape), bands)


def test_adapter_channels_and_shape_error():
    adapter = image.ImageInputAdapter(SHAPE, 4)
    assert adapter.num_input_channels == 3 + 2 * (2 * 4 + 1)
    x = torch.rand(2, *SHAPE)
    out = adapter(x)
    assert out.shape == (2, 64, adapter.num_input_channels)
    np.testing.assert_array_equal(out[..., :3].numpy(), x.reshape(2, 64, 3).numpy())
    with pytest.raises(ValueError, match=r"Input image shape \(8, 9, 3\) different from required shape"):
        adapter(torch.zeros(1, 8, 9, 3))
    # the cross-attention q/k channels default to the adapter's input channels
    _, port_cfg = _configs()
    model = image.ImageClassifier(port_cfg, device="cpu")
    assert model.encoder.cross_attn_1.cross_attn.attention.q_proj.weight.shape[0] == adapter.num_input_channels


def _images(rng, b=4):
    return rng.standard_normal((b, *SHAPE)).astype(np.float32)


def test_logits_loss_and_grads_match_jax(models, rng):
    model, params, port = models
    x = _images(rng)
    labels = np.asarray([0, 3, 4, 1], np.int32)
    want_logits = jax.jit(lambda p, x: model.apply({"params": p}, x))(params, x)
    got = port(torch.from_numpy(x))
    assert got.shape == (4, 5)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want_logits), **TOL)
    batch = {"image": x, "label": labels}
    loss_fn = jax_tasks.image_classifier_loss_fn(model)
    (want, aux), grads = jax.jit(jax.value_and_grad(lambda p: loss_fn(p, batch, None), has_aux=True))(params)
    port.zero_grad()
    loss, metrics = tasks.image_classifier_loss_fn(port)(
        port, {"image": torch.from_numpy(x), "label": torch.from_numpy(labels)}, None)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), **TOL)
    np.testing.assert_allclose(metrics["accuracy"].item(), float(aux["accuracy"]), **TOL)
    want_grads = state_dict_from_jax(_np(grads))
    assert sorted(want_grads) == sorted(n for n, _ in port.named_parameters())
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[name].numpy(), atol=1e-5, rtol=1e-4,
                                   err_msg=name)


def test_config_round_trips_and_serves_from_pretrained(models, rng, tmp_path):
    jax_cfg, port_cfg = _configs()
    assert port_config.config_to_dict(port_cfg) == jax_config.config_to_dict(jax_cfg)
    assert port_config.config_from_dict(None, jax_config.config_to_dict(jax_cfg)) == port_cfg
    _, _, port = models
    port_checkpoint.save_pretrained(str(tmp_path), port, port_cfg)
    assert port_checkpoint.load_config(str(tmp_path)) == port_cfg
    assert isinstance(model_for_config(port_cfg, device="cpu"), image.ImageClassifier)
    imgs = rng.integers(0, 256, (3, *SHAPE), dtype=np.uint8)
    served = pipeline_from_pretrained("image-classification", str(tmp_path), device="cpu")(imgs, top_k=3)
    assert served == pipeline("image-classification", port, device="cpu")(imgs, top_k=3)


@pytest.mark.parametrize("top_k", [1, 3])
def test_image_classification_pipeline_matches_jax(models, rng, top_k):
    model, params, port = models
    imgs = rng.integers(0, 256, (4, *SHAPE), dtype=np.uint8)
    labels = [f"class {i}" for i in range(5)]
    for kw in ({}, {"labels": labels}):
        want = jax_pipeline("image-classification", model, params, **kw)(imgs, top_k=top_k)
        got = pipeline("image-classification", port, device="cpu", **kw)(imgs, top_k=top_k)
        assert [[r["label"] for r in row] for row in got] == [[r["label"] for r in row] for row in want]
        np.testing.assert_allclose([[r["score"] for r in row] for row in got],
                                   [[r["score"] for r in row] for row in want], **TOL)
    assert all(len(row) == top_k for row in got)


# -- the data layer (tests/test_data_vision.py) ----------------------------------------


def test_preprocessors_and_resize_match_jax(rng):
    for shape in ((28, 28), (2, 28, 28, 1), (3, 28, 28), (28, 28, 3)):
        imgs = rng.integers(0, 256, shape, dtype=np.uint8)
        np.testing.assert_array_equal(vision.ImagePreprocessor()(imgs), jax_vision.ImagePreprocessor()(imgs))
    img = rng.integers(0, 256, (37, 53, 3), dtype=np.uint8)
    for out_hw in ((37, 53), (20, 31), (80, 64)):
        np.testing.assert_array_equal(vision.resize_bilinear(img, out_hw), jax_vision.resize_bilinear(img, out_hw))
    batch = [rng.integers(0, 256, (256, 320, 3), dtype=np.uint8), rng.integers(0, 256, (300, 260), dtype=np.uint8)]
    prep, jax_prep = vision.ImageNetPreprocessor(), jax_vision.ImageNetPreprocessor()
    got = prep(batch)
    assert got.shape == (2, 224, 224, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, jax_prep(batch))
    np.testing.assert_array_equal(prep(batch[0]), jax_prep(batch[0]))
    np.testing.assert_array_equal(prep(batch, rng=np.random.default_rng(3)),
                                  jax_prep(batch, rng=np.random.default_rng(3)))
    small = rng.integers(0, 256, (6, 10, 10, 1), dtype=np.uint8)
    np.testing.assert_array_equal(
        vision.random_crop_and_flip(small, np.random.default_rng(5), flip=True),
        jax_vision.random_crop_and_flip(small, np.random.default_rng(5), flip=True))


def _arrays(n, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (n, 28, 28, 1), dtype=np.uint8), rng.integers(0, 10, n).astype(np.int64)


def _same_batches(got, want, n):
    for _ in range(n):
        a, b = next(got), next(want)
        assert sorted(a) == sorted(b) == ["image", "label"]
        for key in a:
            np.testing.assert_array_equal(np.asarray(a[key]), np.asarray(b[key]), err_msg=key)
            assert np.asarray(a[key]).dtype == np.asarray(b[key]).dtype


def test_data_modules_match_jax():
    splits = (_arrays(48, 0), _arrays(16, 1), _arrays(16, 2))
    dms = [cls.from_arrays(*splits, batch_size=8, seed=3)
           for cls in (vision.MNISTDataModule, jax_vision.MNISTDataModule)]
    for dm in dms:
        dm.setup()
    for loader in ("train_dataloader", "val_dataloader", "test_dataloader"):
        _same_batches(iter(getattr(dms[0], loader)()), iter(getattr(dms[1], loader)()), 2)
    without_test = vision.MNISTDataModule.from_arrays(*splits[:2], batch_size=8)
    with pytest.raises(ValueError, match="no test split"):
        without_test.test_dataloader()
    synth = [cls(batch_size=8, num_train=32, num_valid=16, num_test=16, seed=4)
             for cls in (vision.SyntheticImageDataModule, jax_vision.SyntheticImageDataModule)]
    for dm in synth:
        dm.prepare_data()
        dm.setup()
    assert synth[0].image_shape == (28, 28, 1) and synth[0].num_classes == 10
    for loader in ("train_dataloader", "val_dataloader", "test_dataloader"):
        _same_batches(iter(getattr(synth[0], loader)()), iter(getattr(synth[1], loader)()), 2)


# -- the CLI (tests/test_cli_families.py) ----------------------------------------------

CLI_ENCODER = dict(num_frequency_bands=4, num_cross_attention_heads=1, num_self_attention_heads=2,
                   num_self_attention_layers_per_block=1)
CLI_FLAGS = [f"--model.encoder.{k}={v}" for k, v in CLI_ENCODER.items()] + [
    "--model.num_latents=4", "--model.num_latent_channels=16", "--model.decoder.num_output_query_channels=12",
    "--model.decoder.num_cross_attention_heads=2", "--data=synthetic", "--data.batch_size=8",
    "--data.num_train=32", "--data.num_valid=8", "--data.num_test=8", "--optimizer.lr=1e-3",
    "--lr_scheduler.warmup_steps=1", "--trainer.max_steps=3", "--trainer.val_check_interval=3",
    "--trainer.log_every_n_steps=1", "--trainer.enable_checkpointing=false", "--trainer.enable_tensorboard=false",
    "--trainer.limit_val_batches=1", "--trainer.limit_test_batches=1"]


def test_cli_fit_validate_test_match_jax(tmp_path):
    """Both image CLIs (fp32, MNIST's shape over the synthetic data module)
    from the same weights: fit's logged losses and validate/test's metrics
    agree at 1e-5 relative."""
    shape = dict(CLI_ENCODER, image_shape=(28, 28, 1))
    dec = dict(num_output_query_channels=12, num_cross_attention_heads=2, num_classes=10)
    jax_cfg, port_cfg = _configs(shape, dec, dict(num_latents=4, num_latent_channels=16))
    params = _seeded_params(jax_image.ImageClassifier(jax_cfg), jnp.zeros((1, 28, 28, 1), jnp.float32))
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    jax_checkpoint.save_pretrained(str(jax_dir), jax.device_get(params), jax_cfg)
    port_checkpoint.save_pretrained(str(port_dir), load_jax_params(image.ImageClassifier(port_cfg, device="cpu"),
                                                                   _np(params)), port_cfg)
    runs = {}
    for name, main, extra, ckpt in (("jax", jax_cli.CLI(jax_script.FAMILY).main, ["--mesh.data=1"], jax_dir),
                                    ("port", port_cli.CLI(port_script.FAMILY).main, ["--device=cpu"], port_dir)):
        root = tmp_path / f"{name}_fit"
        runs[name] = main(["fit", *CLI_FLAGS, *extra, f"--params={ckpt}", f"--trainer.default_root_dir={root}"])
        rows = [json.loads(line) for line in open(root / "metrics.jsonl")]
        runs[f"{name}_losses"] = {key: [(r["step"], r[key]) for r in rows if key in r]
                                  for key in ("train/loss", "val/loss")}
        for sub in ("validate", "test"):
            runs[f"{name}_{sub}"] = main([sub, *CLI_FLAGS, *extra, f"--ckpt={ckpt}",
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
    assert port_script.FAMILY.defaults == jax_script.FAMILY.defaults
    values = {k: v for k, v in port_script.FAMILY.defaults.items() if k.startswith("model.")}
    values["model.encoder.image_shape"] = (28, 28, 1)
    cfgs = [cli.build_dataclass(family.config_class, values, "model", family.nested)
            for cli, family in ((port_cli, port_script.FAMILY), (jax_cli, jax_script.FAMILY))]
    assert port_config.config_to_dict(cfgs[0]) == jax_config.config_to_dict(cfgs[1])
    assert (cfgs[0].num_latents, cfgs[0].num_latent_channels) == (32, 128)
    assert (port_cli.flag_specs(port_script.FAMILY.config_class, "model", port_script.FAMILY.nested).keys()
            == jax_cli.flag_specs(jax_script.FAMILY.config_class, "model", jax_script.FAMILY.nested).keys())
    assert sorted(port_script.DATA) == sorted(jax_script.DATA)


def test_published_width_parameter_count():
    """deepmind/vision-perceiver-fourier: 224 x 224 x 3, 64 bands, 512 x 1024
    latents, one cross head, 8 blocks x 6 self-attends (shared) of 8 heads,
    1000 classes; the reference counts 48,440,627 parameters."""
    from perceiver_io_tpu_torch.models.text.classifier import classification_decoder

    widths = (dict(image_shape=(224, 224, 3), num_frequency_bands=64, num_cross_attention_heads=1,
                   num_self_attention_heads=8, num_self_attention_layers_per_block=6, num_self_attention_blocks=8),
              dict(num_classes=1000, num_output_query_channels=1024, num_cross_attention_heads=1),
              dict(num_latents=512, num_latent_channels=1024))
    jax_cfg, port_cfg = _configs(*widths)
    shapes = jax.eval_shape(jax_image.ImageClassifier(jax_cfg).init, KEY, jnp.zeros((1, 224, 224, 3)))
    with torch.device("meta"):
        modules = (image.image_encoder(port_cfg), classification_decoder(port_cfg, torch.float32, "auto"))
    port_count = sum(p.numel() for m in modules for p in m.parameters())
    assert port_count == sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(shapes)) == 48_440_627
