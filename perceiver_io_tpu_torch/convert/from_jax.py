"""Weight bridge: a JAX (flax) param tree, as nested dicts of numpy arrays,
to the port's ``state_dict``.

The map of ``perceiver_io_tpu/convert/torch_import.py`` read backwards:

==============================  =======================================
flax                            torch
==============================  =======================================
``Dense.kernel`` (in, out)      ``Linear.weight`` (out, in), transposed
``Dense.bias``                  ``Linear.bias``
``LayerNorm.scale``             ``LayerNorm.weight``
``Embed.embedding``             ``Embedding.weight``
``layers_<i>``                  ``layers.<i>`` (``nn.ModuleList``)
``output_adapter.bias``         ``output_adapter.bias``, as it is
==============================  =======================================
"""
from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

_LEAF = {"scale": "weight", "embedding": "weight", "bias": "bias"}
_LIST_ITEM = re.compile(r"^(\w+)_(\d+)$")


def _flatten(tree: Mapping[str, Any], prefix=()) -> Dict[tuple, np.ndarray]:
    out = {}
    for key, val in tree.items():
        if isinstance(val, Mapping):
            out.update(_flatten(val, prefix + (key,)))
        else:
            out[prefix + (key,)] = np.asarray(val)
    return out


def _module_path(parts) -> str:
    names = []
    for p in parts:
        m = _LIST_ITEM.match(p)
        names.append(f"{m.group(1)}.{m.group(2)}" if m and m.group(1) == "layers" else p)
    return ".".join(names)


def torch_name(flax_path: str) -> str:
    """The ``state_dict`` name of a flax parameter path, or the module prefix
    of a path that ends at a module (``"perceiver_ar/self_attention/layers_0"``
    -> ``"perceiver_ar.self_attention.layers.0"``)."""
    *mod, last = flax_path.strip("/").split("/")
    if last == "kernel":
        return ".".join(filter(None, (_module_path(mod), "weight")))
    if last in _LEAF:
        return ".".join(filter(None, (_module_path(mod), _LEAF[last])))
    return _module_path([*mod, last])


def state_dict_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """``state_dict`` of the port's model from a JAX param tree (the
    ``params`` collection, with or without its ``{"params": ...}`` wrapper).
    A tree of the params' shape, JAX gradients or Adam moments, maps the same
    way."""
    if set(params) == {"params"}:
        params = params["params"]
    out = {}
    for path, arr in _flatten(params).items():
        if path[-1] != "kernel" and path[-1] not in _LEAF:
            raise KeyError(f"unknown flax parameter {'/'.join(path)}")
        arr = arr.T if path[-1] == "kernel" else arr
        out[torch_name("/".join(path))] = torch.tensor(arr, dtype=torch.float32)
    return out


def load_jax_params(model: torch.nn.Module, params: Mapping[str, Any]) -> torch.nn.Module:
    """Load a JAX param tree into ``model`` (``strict=True``); returns it."""
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    return model
