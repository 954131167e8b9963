"""Best-``val_loss`` checkpoints of a training run. Counterpart of
``BestCheckpointManager`` in ``perceiver_io_tpu/training/checkpoint.py``
(the reference's ``ModelCheckpoint(monitor="val_loss",
save_weights_only=True)``).

The format is torch's own: each kept checkpoint is a directory
``<step>/`` holding the model's ``state_dict`` (``model.pt``, written with
``torch.save``, tensors on the CPU) and its ``val_loss`` (``metrics.json``),
beside one ``config.json`` with the model config. It is not orbax-readable,
and the JAX package cannot read it. Full train-state snapshots for resume
(``ResumeCheckpointManager``) are not ported yet.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

CONFIG_FILE = "config.json"
MODEL_FILE = "model.pt"
METRICS_FILE = "metrics.json"


def config_to_dict(config: Any) -> Optional[dict]:
    """A model config (a dataclass) as JSON-ready data, with its class name."""
    if config is None:
        return None
    return {"class": type(config).__name__, **dataclasses.asdict(config)}


class BestCheckpointManager:
    """Keeps the ``max_to_keep`` best checkpoints by ``val_loss`` (lowest
    first) under ``directory``."""

    def __init__(self, directory: str, *, max_to_keep: int = 1):
        if max_to_keep < 1:
            raise ValueError(f"max_to_keep must be >= 1, got {max_to_keep}")
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _kept(self) -> Dict[int, float]:
        """``{step: val_loss}`` of the checkpoints on disk."""
        kept = {}
        for name in os.listdir(self.directory):
            path = os.path.join(self.directory, name, METRICS_FILE)
            if name.isdigit() and os.path.exists(path):
                with open(path) as f:
                    kept[int(name)] = json.load(f)["val_loss"]
        return kept

    def save(self, step: int, model: nn.Module, config: Any, val_loss: float) -> None:
        with open(os.path.join(self.directory, CONFIG_FILE), "w") as f:
            json.dump({"model_config": config_to_dict(config)}, f, indent=2, default=str)
        path = os.path.join(self.directory, str(step))
        os.makedirs(path, exist_ok=True)
        state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
        torch.save(state, os.path.join(path, MODEL_FILE))
        with open(os.path.join(path, METRICS_FILE), "w") as f:
            json.dump({"step": step, "val_loss": float(val_loss)}, f)
        ranked = sorted(self._kept().items(), key=lambda kv: (kv[1], kv[0]))
        for old, _ in ranked[self.max_to_keep:]:
            shutil.rmtree(os.path.join(self.directory, str(old)))

    @property
    def best_step(self) -> Optional[int]:
        kept = self._kept()
        return min(kept, key=lambda s: (kept[s], s)) if kept else None

    def restore_best(self) -> Tuple[Dict[str, torch.Tensor], Optional[dict]]:
        """``(state_dict, model config as a dict or None)`` of the best
        checkpoint; load the first with ``model.load_state_dict``."""
        step = self.best_step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        state = torch.load(os.path.join(self.directory, str(step), MODEL_FILE), weights_only=True)
        with open(os.path.join(self.directory, CONFIG_FILE)) as f:
            config = json.load(f).get("model_config")
        return state, config
