"""The port's converters and FLOP counts against the JAX package, on the CPU
(mirrors ``tests/test_hf_convert.py``, ``tests/test_export.py``'s
round trips and ``tests/test_utils.py``'s estimator cases).

- **Hugging Face import**: random in-memory ``transformers`` models (no hub
  access) of the masked LM, the Fourier image classifier and optical flow;
  the port's ``import_hf_*`` into the port's model gives HF's logits at
  1e-4 and the JAX package's (its own import into its own model) at 1e-5;
  the configs come the same from a ``types.SimpleNamespace`` of the HF
  config's attributes.
- **Export and import**: per task model (the CLM with and without an
  output norm and a position embedding, symbolic audio, the tied and the
  untied masked LM, the text classifier with unshared towers, the image
  classifier, optical flow), seeded JAX weights carried into the port by
  ``convert/from_jax.py``: the port's ``export_*`` equals JAX's key for key
  and value for value, ``torch_import`` of it gives back the port's
  ``state_dict`` exactly, and ``save_reference_checkpoint`` writes JAX's
  ``config.json`` and tensors.
- **FLOP counts**: every estimator of ``utils/flops.py`` equals JAX's at
  clm-base's and GiantMIDI's widths, and ``count_params`` of the port's
  models equals JAX's.
"""
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from perceiver_io_tpu.convert import export as jax_export  # noqa: E402
from perceiver_io_tpu.convert import hf_import as jax_hf  # noqa: E402
from perceiver_io_tpu.convert import torch_import as jax_import  # noqa: E402
from perceiver_io_tpu.models import model_for_config as jax_model_for_config  # noqa: E402
from perceiver_io_tpu.models.audio import symbolic as jax_symbolic  # noqa: E402
from perceiver_io_tpu.models.core import config as jax_config  # noqa: E402
from perceiver_io_tpu.models.text import clm as jax_clm  # noqa: E402
from perceiver_io_tpu.models.text import common as jax_common  # noqa: E402
from perceiver_io_tpu.models.text import mlm as jax_mlm  # noqa: E402
from perceiver_io_tpu.models.vision import image_classifier as jax_image  # noqa: E402
from perceiver_io_tpu.models.vision import optical_flow as jax_flow  # noqa: E402
from perceiver_io_tpu.utils import flops as jax_flops  # noqa: E402
from perceiver_io_tpu_torch import convert  # noqa: E402
from perceiver_io_tpu_torch.convert import export, hf_import, torch_import  # noqa: E402
from perceiver_io_tpu_torch.convert.from_jax import load_jax_params  # noqa: E402
from perceiver_io_tpu_torch.models import model_for_config  # noqa: E402
from perceiver_io_tpu_torch.models.audio import symbolic  # noqa: E402
from perceiver_io_tpu_torch.models.core import config as port_config  # noqa: E402
from perceiver_io_tpu_torch.models.text import clm, common, mlm  # noqa: E402
from perceiver_io_tpu_torch.models.vision import image_classifier as image  # noqa: E402
from perceiver_io_tpu_torch.models.vision import optical_flow as flow  # noqa: E402
from perceiver_io_tpu_torch.utils import flops  # noqa: E402

KEY = jax.random.PRNGKey(0)
HF_TOL = dict(atol=1e-4, rtol=1e-4)  # the reference's conversion tolerance
TOL = dict(atol=1e-5, rtol=1e-5)


def _namespace(config):
    """The HF config's attributes on a plain object, as where
    ``transformers`` is not installed."""
    return types.SimpleNamespace(**config.to_dict(), num_labels=config.num_labels)


def _port_logits(config_fn, import_fn, hf_model, cls, *args):
    config = config_fn(hf_model.config)
    assert config == config_fn(_namespace(hf_model.config))
    port = cls(config, device="cpu")
    port.load_state_dict(import_fn(hf_model.state_dict(), config), strict=True)
    with torch.no_grad():
        return port(*args).numpy(), port


def _jax_logits(config_fn, import_fn, hf_model, cls, *args):
    config = config_fn(hf_model.config)
    params = import_fn(hf_model.state_dict(), config)
    return np.asarray(jax.jit(lambda p, *a: cls(config).apply({"params": p}, *a))(params, *args))


# -- Hugging Face import (tests/test_hf_convert.py) -----------------------------------


def test_mlm_logits_match_hf_and_jax():
    from transformers.models.perceiver.modeling_perceiver import PerceiverForMaskedLM

    torch.manual_seed(0)
    hf = PerceiverForMaskedLM(transformers.PerceiverConfig(
        vocab_size=64, max_position_embeddings=48, d_model=32, d_latents=24, num_latents=8, num_blocks=1,
        num_self_attends_per_block=2, num_self_attention_heads=2, num_cross_attention_heads=2, qk_channels=16,
        v_channels=24, attention_probs_dropout_prob=0.0, tie_word_embeddings=True, hidden_act="gelu")).eval()
    ids = np.random.default_rng(0).integers(0, 64, (2, 48))
    pad = np.zeros((2, 48), bool)
    pad[0, 40:] = True  # a padded tail on row 0
    with torch.no_grad():
        want = hf(input_ids=torch.tensor(ids), attention_mask=torch.tensor(~pad)).logits.numpy()
    got, port = _port_logits(hf_import.mlm_config_from_hf, hf_import.import_hf_masked_language_model, hf,
                             mlm.MaskedLanguageModel, torch.tensor(ids), torch.tensor(pad))
    jax_got = _jax_logits(jax_hf.mlm_config_from_hf, jax_hf.import_hf_masked_language_model, hf,
                          jax_mlm.MaskedLanguageModel, jnp.asarray(ids), jnp.asarray(pad))
    live = [(1, slice(None)), (0, slice(0, 40))]  # real positions
    for row, cols in live:
        np.testing.assert_allclose(got[row, cols], want[row, cols], **HF_TOL)
        np.testing.assert_allclose(got[row, cols], jax_got[row, cols], **TOL)
    assert sum(p.numel() for p in port.parameters()) == sum(p.numel() for p in hf.parameters() if p.requires_grad)


def test_image_classifier_logits_match_hf_and_jax():
    from transformers.models.perceiver.modeling_perceiver import PerceiverForImageClassificationFourier

    torch.manual_seed(0)
    hf = PerceiverForImageClassificationFourier(transformers.PerceiverConfig(
        d_model=261, d_latents=32, num_latents=8, num_blocks=1, num_self_attends_per_block=2,
        num_self_attention_heads=2, num_cross_attention_heads=1, qk_channels=None, v_channels=None,
        attention_probs_dropout_prob=0.0, hidden_act="gelu", num_labels=10)).eval()
    images = np.random.default_rng(0).standard_normal((1, 224, 224, 3)).astype(np.float32)
    with torch.no_grad():
        want = hf(inputs=torch.tensor(images.transpose(0, 3, 1, 2))).logits.numpy()
    got, _ = _port_logits(hf_import.image_classifier_config_from_hf, hf_import.import_hf_image_classifier, hf,
                          image.ImageClassifier, torch.from_numpy(images))
    jax_got = _jax_logits(jax_hf.image_classifier_config_from_hf, jax_hf.import_hf_image_classifier, hf,
                          jax_image.ImageClassifier, jnp.asarray(images))
    np.testing.assert_allclose(got, want, **HF_TOL)
    np.testing.assert_allclose(got, jax_got, **TOL)


def test_optical_flow_logits_match_hf_and_jax():
    from transformers.models.perceiver.modeling_perceiver import PerceiverForOpticalFlow

    torch.manual_seed(0)
    hf = PerceiverForOpticalFlow(transformers.PerceiverConfig(
        train_size=[6, 8], d_model=322, d_latents=24, num_latents=8, num_blocks=1, num_self_attends_per_block=2,
        num_self_attention_heads=2, num_cross_attention_heads=1, qk_channels=None, v_channels=None,
        attention_probs_dropout_prob=0.0, hidden_act="gelu")).eval()
    x = np.random.default_rng(0).standard_normal((2, 2, 27, 6, 8)).astype(np.float32)
    with torch.no_grad():
        want = hf(inputs=torch.tensor(x)).logits.numpy()
    got, port = _port_logits(hf_import.optical_flow_config_from_hf, hf_import.import_hf_optical_flow, hf,
                             flow.OpticalFlow, torch.from_numpy(x))
    jax_got = _jax_logits(jax_hf.optical_flow_config_from_hf, jax_hf.import_hf_optical_flow, hf,
                          jax_flow.OpticalFlow, jnp.asarray(x))
    assert got.shape == (2, 6, 8, 2)
    np.testing.assert_allclose(got, want, **HF_TOL)
    np.testing.assert_allclose(got, jax_got, **TOL)
    assert not port.decoder.cross_attn.attention_residual
    bad = _namespace(hf.config)
    bad.d_model = 320
    with pytest.raises(AssertionError, match="flow d_model must be 322"):
        hf_import.optical_flow_config_from_hf(bad)
    bad.d_model, bad.hidden_act = 322, "relu"
    with pytest.raises(AssertionError):
        hf_import.optical_flow_config_from_hf(bad)


# -- export and import (tests/test_export.py's round trips) ---------------------------

SEQ = dict(vocab_size=262, max_seq_len=32, max_latents=16, num_channels=32, num_heads=2,
           num_self_attention_layers=2, cross_attention_dropout=0.0)
TEXT = dict(vocab_size=262, max_seq_len=32, num_input_channels=16, num_cross_attention_heads=2,
            num_self_attention_heads=2, num_self_attention_layers_per_block=2)
LATENTS = dict(num_latents=4, num_latent_channels=16)
FLOW = dict(image_shape=(8, 12), num_patch_hidden_channels=16, num_frequency_bands=4, num_cross_attention_heads=1,
            num_self_attention_heads=2, num_self_attention_layers_per_block=2)


def _io(enc_mod, enc_cls, dec_mod, dec_cls, enc, dec):
    """The same Perceiver IO config in both packages (``*_mod`` pairs of
    (JAX module, port module))."""
    return tuple(config_mod.PerceiverIOConfig(getattr(e, enc_cls)(**enc), getattr(d, dec_cls)(**dec), **LATENTS)
                 for config_mod, e, d in ((jax_config, enc_mod[0], dec_mod[0]),
                                          (port_config, enc_mod[1], dec_mod[1])))


def _cases():
    """task -> (JAX config, port config, the JAX init's input)."""
    ids = jnp.zeros((1, 32), jnp.int32)
    text, cfgs = (jax_common, common), (jax_config, port_config)
    unshared = dict(TEXT, num_cross_attention_layers=2, num_self_attention_blocks=2,
                    first_self_attention_block_shared=False)
    return {
        "clm": (jax_clm.CausalLanguageModelConfig(**SEQ), clm.CausalLanguageModelConfig(**SEQ), (ids, 16)),
        "clm_norm_rotary": (jax_clm.CausalLanguageModelConfig(**SEQ, output_norm=True, abs_pos_emb=False),
                            clm.CausalLanguageModelConfig(**SEQ, output_norm=True, abs_pos_emb=False), (ids, 16)),
        "sam": (jax_symbolic.SymbolicAudioModelConfig(**dict(SEQ, vocab_size=389)),
                symbolic.SymbolicAudioModelConfig(**dict(SEQ, vocab_size=389)), (ids, 16)),
        "mlm_tied": (*_io(text, "TextEncoderConfig", (jax_mlm, mlm), "TextDecoderConfig", TEXT,
                          dict(vocab_size=262, max_seq_len=32, num_cross_attention_heads=2,
                               cross_attention_residual=False)), (ids,)),
        "mlm_untied": (*_io(text, "TextEncoderConfig", (jax_mlm, mlm), "TextDecoderConfig", TEXT,
                            dict(vocab_size=262, max_seq_len=32, num_output_query_channels=12,
                                 num_cross_attention_heads=2)), (ids,)),
        "txt_clf": (*_io(text, "TextEncoderConfig", cfgs, "ClassificationDecoderConfig", unshared,
                         dict(num_output_query_channels=12, num_classes=3, num_cross_attention_heads=2)), (ids,)),
        "img_clf": (*_io((jax_image, image), "ImageEncoderConfig", cfgs, "ClassificationDecoderConfig",
                         dict(image_shape=(8, 8, 3), num_frequency_bands=4, num_cross_attention_heads=1,
                              num_self_attention_heads=2, num_self_attention_layers_per_block=2),
                         dict(num_output_query_channels=12, num_classes=5, num_cross_attention_heads=2)),
                    (jnp.zeros((1, 8, 8, 3)),)),
        "flow": (*_io((jax_flow, flow), "OpticalFlowEncoderConfig", (jax_flow, flow), "OpticalFlowDecoderConfig",
                      FLOW, dict(image_shape=(8, 12), num_cross_attention_heads=1, cross_attention_residual=False)),
                 (jnp.zeros((1, 2, 27, 8, 12)),)),
    }


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
def carried():
    """task -> (JAX config, seeded JAX params, port config, the port model
    carrying the same weights)."""
    out = {}
    for i, (name, (jax_cfg, port_cfg, args)) in enumerate(_cases().items()):
        model = jax_model_for_config(jax_cfg)
        shapes = jax.eval_shape(lambda: model.init(KEY, *args))["params"]  # the prefix length stays static
        rng = np.random.default_rng(i)
        params = jax.tree_util.tree_map(lambda s: (rng.standard_normal(s.shape) * 0.1).astype(np.float32), shapes)
        port = load_jax_params(model_for_config(port_cfg, device="cpu", seed=1), params)
        out[name] = (jax_cfg, params, port_cfg, port)
    return out


@pytest.mark.parametrize("name", list(_cases()))
def test_export_import_and_reference_dir_match_jax(carried, name, tmp_path):
    jax_cfg, params, port_cfg, port = carried[name]
    task = export.infer_task(port_cfg)
    assert task == jax_export.infer_task(jax_cfg)
    exporter = export.TASKS[task][0]
    want = jax_export.TASKS[task][0](params, jax_cfg)
    got = exporter(port.state_dict(), port_cfg)
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        assert got[key].dtype == np.float32
        np.testing.assert_array_equal(got[key], value, err_msg=key)
    importer = {"clm": convert.import_causal_language_model, "sam": convert.import_symbolic_audio_model,
                "mlm": convert.import_masked_language_model, "txt-clf": convert.import_text_classifier,
                "img-clf": convert.import_image_classifier, "flow": convert.import_optical_flow}[task]
    back = importer(got, port_cfg)
    state = port.state_dict()
    assert sorted(back) == sorted(state)
    for key, value in state.items():
        assert torch.equal(back[key], value), key
    # JAX's importer reads the same export back into its params
    jax.tree_util.tree_map(np.testing.assert_array_equal, getattr(jax_import, importer.__name__)(got, jax_cfg),
                           params)
    ours, theirs = tmp_path / "port", tmp_path / "jax"
    export.save_reference_checkpoint(state, port_cfg, str(ours), task)
    jax_export.save_reference_checkpoint(params, jax_cfg, str(theirs), task)
    assert json.loads((ours / "config.json").read_text()) == json.loads((theirs / "config.json").read_text())
    a, b = (torch.load(d / "pytorch_model.bin") for d in (ours, theirs))
    assert sorted(a) == sorted(b) and all(torch.equal(a[k], b[k]) for k in a)


def test_export_refuses_mismatches(carried, tmp_path):
    _, _, port_cfg, port = carried["txt_clf"]
    shared = port_config.PerceiverIOConfig(
        common.TextEncoderConfig(**TEXT), port_cfg.decoder, **LATENTS)  # no unshared towers
    with pytest.raises(ValueError, match="config/weights mismatch"):
        export.export_text_classifier(port.state_dict(), shared)
    with pytest.raises(KeyError, match="cross_attn_n"):
        export.export_text_classifier({k: v for k, v in port.state_dict().items() if "cross_attn_n" not in k},
                                      port_cfg)
    with pytest.raises(ValueError, match="task mismatch"):
        export.save_reference_checkpoint(port.state_dict(), port_cfg, str(tmp_path), "mlm")
    with pytest.raises(ValueError, match="unknown task"):
        export.save_reference_checkpoint(port.state_dict(), port_cfg, str(tmp_path), "seq2seq")
    with pytest.raises(ValueError, match="unknown task"):
        torch_import.module_map("seq2seq", port_cfg)


# -- FLOP counts (tests/test_utils.py) -------------------------------------------------

#: (vocab, context, latents, channels, layers incl. the cross attention): clm-base, GiantMIDI
WIDTHS = {"clm_base": (32000, 1024, 512, 896, 17), "giantmidi": (389, 6144, 2048, 768, 13)}


@pytest.mark.parametrize("width", list(WIDTHS))
def test_flops_match_jax(width):
    vocab, context, latents, channels, layers = WIDTHS[width]
    est, jax_est = flops.ComputeEstimator(vocab, context, latents), jax_flops.ComputeEstimator(vocab, context, latents)
    for dropout in (0.0, 0.5):
        assert est.total(channels, layers, dropout) == jax_est.total(channels, layers, dropout)
        assert est.cross_attn(channels, dropout) == jax_est.cross_attn(channels, dropout)
        assert (flops.training_flops(est, channels, layers, 100, 8, dropout)
                == jax_flops.training_flops(jax_est, channels, layers, 100, 8, dropout))
        assert (flops.training_flops_per_step(est, channels, layers, 8, dropout)
                == jax_flops.training_flops_per_step(jax_est, channels, layers, 8, dropout))
    assert est.self_attn(channels, layers) == jax_est.self_attn(channels, layers)
    assert flops.num_training_steps(10**9, latents, 8) == jax_flops.num_training_steps(10**9, latents, 8)
    assert flops.num_training_tokens(500, latents, 8) == jax_flops.num_training_tokens(500, latents, 8)
    runs = ([1e18, 1e19, 1e20], [1e8, 3e8, 1e9], [2e9, 6e9, 2e10])
    law, jax_law = flops.fit_scaling_law(*runs, 0.5, 0.5), jax_flops.fit_scaling_law(*runs, 0.5, 0.5)
    assert str(law) == str(jax_law) and law.n_opt(1e21) == jax_law.n_opt(1e21)


def test_count_params_matches_jax(carried):
    for name, (jax_cfg, params, _, port) in carried.items():
        n = jax_flops.count_params(jax_model_for_config(jax_cfg), *_cases()[name][2])
        assert flops.count_params(port) == n, name
        assert flops.flops_approx(flops.count_params(port)) == jax_flops.flops_approx(n)
