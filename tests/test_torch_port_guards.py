"""Guards of the PyTorch port: it imports neither JAX, flax nor the JAX
package; its entry points refuse to run off the card unless asked for the
CPU; and ``chip_smoke.py`` fails where there is no card."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "perceiver_io_tpu_torch"

_IMPORT_ALL = r"""
import importlib, json, pkgutil, sys
import perceiver_io_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m in ("jax", "flax", "perceiver_io_tpu")
             or m.startswith(("jax.", "flax.", "perceiver_io_tpu.")))
# imported only inside the code that needs them: the card's machine lacks them
lazy = sorted(m for m in sys.modules if m.split(".")[0] in ("transformers", "datasets", "yaml"))
print(json.dumps({"imported": names, "bad": bad, "lazy": lazy}))
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [str(REPO), env.get("PYTHONPATH")]))
    return env


def test_port_imports_no_jax_and_no_jax_package():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO, env=_env(),
                         capture_output=True, text=True, timeout=120, check=True)
    report = json.loads(out.stdout.strip().splitlines()[-1])
    # full module names: perceiver_io_tpu_torch must not pass for the JAX package
    for name in ("serving.engine", "serving.slots", "serving.kv_pool", "ops.flash_attention",
                 "ops.paged_attention", "ops.ragged_attention", "training.trainer",
                 "training.tasks", "training.optim", "training.lrs", "training.checkpoint",
                 "parallel.train_step", "inference.speculative", "inference.decode_strategy",
                 "training.callbacks", "reliability.chaos", "reliability.retry", "data.loader",
                 "data.text.tokenizers", "data.text.collators", "data.text.preprocessor",
                 "data.text.datamodule", "data.text.sources", "data.text.streaming", "scripts.cli",
                 "scripts.text.clm", "scripts.audio.symbolic", "models.core.config", "models.core.adapter",
                 "models.text.common", "models.text.mlm", "inference.mask_filler", "scripts.text.mlm",
                 "models.text.classifier", "models.vision.image_classifier", "data.vision.image",
                 "data.vision.imagenet", "scripts.text.classifier", "scripts.vision.image_classifier",
                 "models.vision.optical_flow", "data.vision.optical_flow", "data.vision.video",
                 "convert.torch_import", "convert.hf_import", "convert.export", "utils.flops"):
        assert f"perceiver_io_tpu_torch.{name}" in report["imported"]
    assert report["bad"] == []
    assert report["lazy"] == []


def test_port_sources_name_no_jax_module():
    for path in PORT.rglob("*.py"):
        for line in path.read_text().splitlines():
            words = line.replace(",", " ").split()
            if words[:1] in (["import"], ["from"]):
                mod = words[1]
                assert mod.split(".")[0] not in ("jax", "flax", "perceiver_io_tpu"), (path, line)


@pytest.mark.parametrize("entry", ["model", "generate", "engine", "trainer", "train_step", "cli", "mlm",
                                   "fill_mask", "text_classifier", "image_classifier", "classifier_cli",
                                   "sentiment", "image_pipeline"])
def test_default_device_entry_points_refuse_the_cpu(entry, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    from perceiver_io_tpu_torch.inference.generate import GenerationConfig, generate
    from perceiver_io_tpu_torch.models.text.clm import CausalLanguageModel, CausalLanguageModelConfig
    from perceiver_io_tpu_torch.parallel import make_train_step
    from perceiver_io_tpu_torch.serving.engine import ServingEngine
    from perceiver_io_tpu_torch.training import Trainer, TrainerConfig, clm_loss_fn, make_optimizer

    cfg = CausalLanguageModelConfig(vocab_size=16, max_seq_len=8, max_latents=4, num_channels=8,
                                    num_heads=2, num_self_attention_layers=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        if entry == "cli":
            # without --device=cpu the CLI refuses before it prepares any data
            from perceiver_io_tpu_torch.scripts.text import clm

            clm.main(["fit", "--data=synthetic", f"--data.dataset_dir={tmp_path}"])
        elif entry in ("mlm", "fill_mask"):
            from perceiver_io_tpu_torch.data.text import ByteTokenizer, TextPreprocessor
            from perceiver_io_tpu_torch.inference.pipelines import pipeline
            from perceiver_io_tpu_torch.models.core.config import PerceiverIOConfig
            from perceiver_io_tpu_torch.models.text.common import TextEncoderConfig
            from perceiver_io_tpu_torch.models.text.mlm import MaskedLanguageModel, TextDecoderConfig

            mlm_cfg = PerceiverIOConfig(TextEncoderConfig(vocab_size=262, max_seq_len=8, num_input_channels=8),
                                        TextDecoderConfig(vocab_size=262, max_seq_len=8), num_latents=2,
                                        num_latent_channels=8)
            if entry == "mlm":
                MaskedLanguageModel(mlm_cfg)
            else:
                pipeline("fill-mask", MaskedLanguageModel(mlm_cfg, device="cpu"),
                         TextPreprocessor(ByteTokenizer(), max_seq_len=8))
        elif entry in ("text_classifier", "sentiment"):
            from perceiver_io_tpu_torch.data.text import ByteTokenizer, TextPreprocessor
            from perceiver_io_tpu_torch.inference.pipelines import pipeline
            from perceiver_io_tpu_torch.models.core.config import ClassificationDecoderConfig, PerceiverIOConfig
            from perceiver_io_tpu_torch.models.text.classifier import TextClassifier
            from perceiver_io_tpu_torch.models.text.common import TextEncoderConfig

            clf_cfg = PerceiverIOConfig(TextEncoderConfig(vocab_size=262, max_seq_len=8, num_input_channels=8),
                                        ClassificationDecoderConfig(num_output_query_channels=8, num_classes=2),
                                        num_latents=2, num_latent_channels=8)
            if entry == "text_classifier":
                TextClassifier(clf_cfg)
            else:
                pipeline("sentiment-analysis", TextClassifier(clf_cfg, device="cpu"),
                         TextPreprocessor(ByteTokenizer(), max_seq_len=8))
        elif entry in ("image_classifier", "image_pipeline"):
            from perceiver_io_tpu_torch.inference.pipelines import pipeline
            from perceiver_io_tpu_torch.models.core.config import ClassificationDecoderConfig, PerceiverIOConfig
            from perceiver_io_tpu_torch.models.vision import ImageClassifier, ImageEncoderConfig

            img_cfg = PerceiverIOConfig(ImageEncoderConfig(image_shape=(4, 4, 1), num_frequency_bands=2,
                                                           num_cross_attention_heads=1),
                                        ClassificationDecoderConfig(num_output_query_channels=8, num_classes=2),
                                        num_latents=2, num_latent_channels=8)
            if entry == "image_classifier":
                ImageClassifier(img_cfg)
            else:
                pipeline("image-classification", ImageClassifier(img_cfg, device="cpu"))
        elif entry == "classifier_cli":
            from perceiver_io_tpu_torch.scripts.vision import image_classifier

            image_classifier.main(["fit", "--data=synthetic"])
        elif entry == "model":
            CausalLanguageModel(cfg)
        elif entry in ("trainer", "train_step"):
            loss_fn = clm_loss_fn(CausalLanguageModel(cfg, device="cpu"), 4)
            if entry == "trainer":
                Trainer(TrainerConfig(max_steps=1, default_root_dir=str(tmp_path)), loss_fn,
                        make_optimizer(1e-3))
            else:
                make_train_step(loss_fn)
        else:
            cpu_model = CausalLanguageModel(cfg, device="cpu")
            if entry == "generate":
                generate(cpu_model, [[1, 2, 3]], GenerationConfig())
            else:
                ServingEngine(cpu_model)


def test_chip_smoke_fails_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")], cwd=REPO, env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    # alone in a directory, without the package, it fails too
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((REPO / "chip_smoke.py").read_text())
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, str(alone)], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and '"ok": true' not in out.stdout
