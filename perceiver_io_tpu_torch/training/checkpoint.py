"""Checkpoints of the port, in three forms. Counterpart of
``perceiver_io_tpu/training/checkpoint.py``:

- **trainer checkpoints** (:class:`BestCheckpointManager`): the best
  ``val_loss`` weights (the reference's ``ModelCheckpoint(monitor="val_loss",
  save_weights_only=True)``) beside the model config;
- **resume snapshots** (:class:`ResumeCheckpointManager`): the whole train
  state (step, model, optimizer and scheduler ``state_dict``s) every N
  steps, for a resumed or rolled-back run;
- **pretrained dirs** (:func:`save_pretrained` / :func:`load_pretrained`,
  :func:`load_subtree` for one submodule): weights beside an embedded
  config, which the inference pipelines load.

The format is torch's own: ``torch.save`` files of CPU tensors (read back
with ``weights_only=True``) and JSON configs (``{"class": <config class>,
**fields}``). It is not orbax-readable and the JAX package cannot read it;
JAX checkpoints reach the port through ``convert/from_jax.py``. A snapshot
is written to a temporary directory and renamed into place, so a crash
mid-write never leaves a partial latest snapshot.

Under a mesh a snapshot is the whole state, gathered
(``TrainState.snapshot``: every rank takes part, the first writes), so it
is the file a run on one device writes, and it restores onto any mesh or
none (``TrainState.restore`` keeps each rank's shards), as JAX's orbax
restore reshards.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from perceiver_io_tpu_torch.convert.from_jax import torch_name
from perceiver_io_tpu_torch.models.core import config as core_config

CONFIG_FILE = "config.json"
MODEL_FILE = "model.pt"
METRICS_FILE = "metrics.json"
STATE_FILE = "state.pt"


def config_to_dict(config: Any) -> Optional[dict]:
    """A model config (a dataclass) as JSON-ready data, with its class name;
    a nested config (``PerceiverIOConfig``'s encoder and decoder) carries
    its own under ``"_type"``, as the JAX package writes it."""
    if config is None:
        return None
    d = core_config.config_to_dict(config)
    return {"class": d.pop("_type"), **d}


def config_from_dict(d: dict) -> Any:
    """The model config of :func:`config_to_dict`'s output: ``"class"``
    names a registered config class (``models.core.config.register_config``),
    else ``ValueError``."""
    body = {k: v for k, v in d.items() if k != "class"}
    return core_config.config_from_dict(None, {**body, "_type": d.get("class")})


def _to_cpu(obj):
    """``obj`` with every tensor in it copied to the CPU."""
    if torch.is_tensor(obj):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def _write_dir(final: str, name: str, payload: Any) -> None:
    """``torch.save`` ``payload`` as ``final/name`` by way of a temporary
    sibling directory renamed into place."""
    tmp = f"{final}.tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(payload, os.path.join(tmp, name))
    shutil.rmtree(final, ignore_errors=True)
    os.replace(tmp, final)


def save_pretrained(path: str, model: nn.Module, config: Any, *,
                    extra: Optional[dict] = None) -> None:
    """A self-describing model dir: ``model.pt`` (the ``state_dict`` on the
    CPU) and ``config.json`` (the config, plus ``extra``)."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    meta = {"model_config": config_to_dict(config)}
    if extra:
        meta.update(extra)
    with open(os.path.join(path, CONFIG_FILE), "w") as f:
        json.dump(meta, f, indent=2, default=str)
    torch.save(_to_cpu(model.state_dict()), os.path.join(path, MODEL_FILE))


def load_config(path: str) -> Any:
    """The model config embedded in a pretrained or trainer checkpoint dir,
    or None."""
    with open(os.path.join(os.path.abspath(path), CONFIG_FILE)) as f:
        d = json.load(f).get("model_config")
    return None if d is None else config_from_dict(d)


def _trainer_checkpoint_root(path: str) -> Optional[str]:
    """The root of a trainer checkpoint dir (numeric step dirs) when
    ``path`` is one or its ``<root>/best`` alias, else None."""
    if os.path.basename(path) == "best" and not os.path.exists(path):
        path = os.path.dirname(path)
    if not os.path.isdir(path) or os.path.exists(os.path.join(path, MODEL_FILE)):
        return None
    return path if any(name.isdigit() for name in os.listdir(path)) else None


def load_pretrained(path: str) -> Tuple[Dict[str, torch.Tensor], Any]:
    """``(state_dict, config)`` of a :func:`save_pretrained` dir, or of the
    best step of a trainer checkpoint dir (``<root>/checkpoints`` or its
    ``<root>/checkpoints/best`` alias). Tensors are on the CPU; load them
    with ``model.load_state_dict``."""
    path = os.path.abspath(path)
    root = _trainer_checkpoint_root(path)
    if root is not None:
        state, d = BestCheckpointManager(root).restore_best()
        return state, None if d is None else config_from_dict(d)
    state = torch.load(os.path.join(path, MODEL_FILE), map_location="cpu", weights_only=True)
    return state, load_config(path)


def load_subtree(path: str, subtree: str) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` of one submodule of a saved model, named from that
    submodule (``subtree`` as a flax path, ``"perceiver_ar"``, or a torch
    prefix): load it with ``model.<submodule>.load_state_dict``."""
    state, _ = load_pretrained(path)
    prefix = torch_name(subtree) + "."
    out = {k[len(prefix):]: v for k, v in state.items() if k.startswith(prefix)}
    if not out:
        raise KeyError(f"no parameters under {subtree!r} in {path}")
    return out


class ResumeCheckpointManager:
    """Whole-train-state snapshots for a resumed or rolled-back run: step,
    model, optimizer and scheduler ``state_dict``s (the last holds the
    learning-rate schedule's position) in ``<directory>/<step>/state.pt``.
    The ``max_to_keep`` latest are kept. As orbax's manager, a save at a
    step no later than the latest snapshot is skipped."""

    def __init__(self, directory: str, *, max_to_keep: int = 2, create: bool = True):
        """:param create: make the directory (the save side). False is a
        read-only restore: a mistyped path raises ``FileNotFoundError`` and
        leaves no directory behind."""
        if max_to_keep < 1:
            raise ValueError(f"max_to_keep must be >= 1, got {max_to_keep}")
        self.directory = os.path.abspath(directory)
        if create:
            os.makedirs(self.directory, exist_ok=True)
        elif not os.path.isdir(self.directory):
            raise FileNotFoundError(f"no resume snapshots in {self.directory}")
        self.max_to_keep = max_to_keep
        self._open = True

    def _check_open(self) -> None:
        if not self._open:
            raise ValueError(f"the snapshot manager of {self.directory} is closed")

    def steps(self) -> list:
        """The snapshot steps on disk, oldest first."""
        return sorted(int(name) for name in os.listdir(self.directory)
                      if name.isdigit() and os.path.exists(os.path.join(self.directory, name, STATE_FILE)))

    @property
    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def _behind(self, step: int) -> bool:
        latest = self.latest_step
        return latest is not None and latest >= step

    def save(self, step: int, state) -> bool:
        """Snapshot ``state`` as step ``step``; False when skipped (not after
        the latest snapshot)."""
        self._check_open()
        if self._behind(step):
            return False
        return self.save_payload(step, state.snapshot())

    def save_payload(self, step: int, payload: dict) -> bool:
        """Write a ``TrainState.snapshot()`` taken already (under a mesh
        every rank gathers, the first writes); False when skipped."""
        self._check_open()
        if self._behind(step):
            return False
        _write_dir(os.path.join(self.directory, str(step)), STATE_FILE, payload)
        for old in self.steps()[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, str(old)))
        return True

    def restore_latest(self, state):
        """Load the latest snapshot into ``state`` (the live train state:
        parameters keep their device, the optimizer places its moments as it
        expects) and return it."""
        self._check_open()
        step = self.latest_step
        if step is None:
            raise FileNotFoundError(f"no resume snapshots in {self.directory}")
        snap = torch.load(os.path.join(self.directory, str(step), STATE_FILE), map_location="cpu",
                          weights_only=True)
        try:
            return state.restore(snap)
        except ValueError as e:
            raise ValueError(f"snapshot {step}: {e}") from None

    def close(self) -> None:
        """Idempotent: a crash path may close after a normal close."""
        self._open = False


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

    def save(self, step: int, model, config: Any, val_loss: float) -> None:
        """``model``: the model, or its whole ``state_dict`` (a sharded
        state's ``model_state_dict()``)."""
        with open(os.path.join(self.directory, CONFIG_FILE), "w") as f:
            json.dump({"model_config": config_to_dict(config)}, f, indent=2, default=str)
        path = os.path.join(self.directory, str(step))
        os.makedirs(path, exist_ok=True)
        sd = model if isinstance(model, dict) else model.state_dict()
        state = {k: v.detach().cpu() for k, v in sd.items()}
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
