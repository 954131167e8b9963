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
print(json.dumps({"imported": names, "bad": bad}))
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
                 "parallel.train_step"):
        assert f"perceiver_io_tpu_torch.{name}" in report["imported"]
    assert report["bad"] == []


def test_port_sources_name_no_jax_module():
    for path in PORT.rglob("*.py"):
        for line in path.read_text().splitlines():
            words = line.replace(",", " ").split()
            if words[:1] in (["import"], ["from"]):
                mod = words[1]
                assert mod.split(".")[0] not in ("jax", "flax", "perceiver_io_tpu"), (path, line)


@pytest.mark.parametrize("entry", ["model", "generate", "engine", "trainer", "train_step"])
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
        if entry == "model":
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
