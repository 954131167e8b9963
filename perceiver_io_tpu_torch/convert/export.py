"""Export the port's weights to the reference (PyTorch ``perceiver-io``)
formats, the inverse of :mod:`.torch_import`. Counterpart of
``perceiver_io_tpu/convert/export.py``: an ``export_*`` per task model
(the model's ``state_dict`` and its config -> the reference backend's
``state_dict`` as float32 NumPy arrays, Perceiver IO halves under ``0.`` /
``1.``), :func:`infer_task` and :func:`save_reference_checkpoint` (a
reference-format ``save_pretrained`` directory).

The renames are :func:`.torch_import.module_map` read from port to
reference. Buffers the reference registers and the port computes on the
fly are written from the config: the vision adapters' Fourier table
(``position_encoding.position_encoding``) and the Perceiver AR adapter's
rotary ``frq_pos_encoding.inv_freq``. A state dict holding a parameter the
config's model does not have, or lacking one it has, raises.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Mapping

import numpy as np
import torch

from perceiver_io_tpu_torch.convert.torch_import import OPTIONAL, module_map, rename
from perceiver_io_tpu_torch.ops.position import _fourier_table

Weights = Mapping[str, Any]  # a port model's state_dict


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().to("cpu", torch.float32).numpy()
    return np.asarray(x, dtype=np.float32)


def _export(task: str, weights: Weights, config) -> Dict[str, np.ndarray]:
    mapping = module_map(task, config, encoder="0", decoder="1")  # the reference's PerceiverIO Sequential
    out = rename(weights, mapping, OPTIONAL)
    used = {k for src in mapping for k in (src, src + ".weight", src + ".bias")}
    extra = sorted(k for k in weights if k not in used)
    if extra:
        raise ValueError(f"config/weights mismatch: the {task!r} config's model has no {extra[:4]}")
    return {k: _np(v) for k, v in out.items()}


def _fourier_buffer(spatial_shape, num_frequency_bands: int) -> np.ndarray:
    """The Fourier table the reference's vision adapters register as a
    buffer (the port computes it, :mod:`perceiver_io_tpu_torch.ops.position`)."""
    return np.asarray(_fourier_table(tuple(spatial_shape), num_frequency_bands), dtype=np.float32)


def _rotary_inv_freq(config) -> np.ndarray:
    """The reference Perceiver AR adapter's ``frq_pos_encoding.inv_freq``
    buffer over the config's rotated channels."""
    dim = config.rotated_channels_per_head
    return (1.0 / (10000 ** (np.arange(0, dim, 2, dtype=np.float32) / dim))).astype(np.float32)


def export_masked_language_model(weights: Weights, config) -> Dict[str, np.ndarray]:
    """The port's ``MaskedLanguageModel`` -> reference ``MaskedLanguageModel``."""
    return _export("mlm", weights, config)


def export_text_classifier(weights: Weights, config) -> Dict[str, np.ndarray]:
    return _export("txt-clf", weights, config)


def export_image_classifier(weights: Weights, config) -> Dict[str, np.ndarray]:
    """With the reference's Fourier buffer (the adapter holds no parameters)."""
    out = {"0.input_adapter.position_encoding.position_encoding": _fourier_buffer(
        config.encoder.image_shape[:-1], config.encoder.num_frequency_bands)}
    out.update(_export("img-clf", weights, config))
    return out


def export_optical_flow(weights: Weights, config) -> Dict[str, np.ndarray]:
    """With the reference's Fourier buffer over the patch grid."""
    out = {"0.input_adapter.position_encoding.position_encoding": _fourier_buffer(
        config.encoder.image_shape, config.encoder.num_frequency_bands)}
    out.update(_export("flow", weights, config))
    return out


def _sequence_model(task: str, weights: Weights, config) -> Dict[str, np.ndarray]:
    out = _export(task, weights, config)
    out["input_adapter.frq_pos_encoding.inv_freq"] = _rotary_inv_freq(config)
    return out


def export_causal_language_model(weights: Weights, config) -> Dict[str, np.ndarray]:
    return _sequence_model("clm", weights, config)


def export_symbolic_audio_model(weights: Weights, config) -> Dict[str, np.ndarray]:
    return _sequence_model("sam", weights, config)


#: task -> (exporter, the reference wrapper's model_type, its class name)
TASKS: Dict[str, Any] = {
    "clm": (export_causal_language_model, "perceiver-ar-causal-language-model", "PerceiverCausalLanguageModel"),
    "sam": (export_symbolic_audio_model, "perceiver-ar-symbolic-audio-model", "PerceiverSymbolicAudioModel"),
    "mlm": (export_masked_language_model, "perceiver-io-masked-language-model", "PerceiverMaskedLanguageModel"),
    "txt-clf": (export_text_classifier, "perceiver-io-text-classifier", "PerceiverTextClassifier"),
    "img-clf": (export_image_classifier, "perceiver-io-image-classifier", "PerceiverImageClassifier"),
    "flow": (export_optical_flow, "perceiver-io-optical-flow", "PerceiverOpticalFlow"),
}


def infer_task(config) -> str:
    """The export task of a config, from its concrete classes (each family
    has its own dataclasses)."""
    name = type(config).__name__
    if name == "CausalLanguageModelConfig":
        return "clm"
    if name == "SymbolicAudioModelConfig":
        return "sam"
    enc = type(getattr(config, "encoder", None)).__name__
    dec = type(getattr(config, "decoder", None)).__name__
    if dec == "TextDecoderConfig":
        return "mlm"
    if dec == "ClassificationDecoderConfig":
        if enc == "TextEncoderConfig":
            return "txt-clf"
        if enc == "ImageEncoderConfig":
            return "img-clf"
    if dec == "OpticalFlowDecoderConfig":
        return "flow"
    raise ValueError(f"cannot infer export task from config type {name} ({enc}/{dec})")


def _jsonable(obj):
    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    return obj


def save_reference_checkpoint(weights: Weights, config, save_dir: str, task: str) -> str:
    """Write a reference-format ``save_pretrained`` directory:
    ``config.json`` (``model_type``, ``model_config`` = the config's fields,
    ``architectures``, ``is_decoder``) and ``pytorch_model.bin`` (the
    backend ``state_dict`` under the wrapper's ``backend_model.`` prefix).
    ``task`` must be the config's own (:func:`infer_task`)."""
    if task not in TASKS:
        raise ValueError(f"unknown task {task!r}; expected one of {sorted(TASKS)}")
    actual = infer_task(config)
    if actual != task:
        raise ValueError(f"task mismatch: requested export as {task!r} but the model's "
                         f"config is a {type(config).__name__} ({actual!r})")
    exporter, model_type, arch = TASKS[task]
    sd = exporter(weights, config)
    os.makedirs(save_dir, exist_ok=True)
    cfg_dict = {"model_type": model_type, "model_config": _jsonable(dataclasses.asdict(config)),
                "architectures": [arch], "is_decoder": task in ("clm", "sam")}
    with open(os.path.join(save_dir, "config.json"), "w") as f:
        json.dump(cfg_dict, f, indent=2)
    torch.save({f"backend_model.{k}": torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()},
               os.path.join(save_dir, "pytorch_model.bin"))
    return save_dir
