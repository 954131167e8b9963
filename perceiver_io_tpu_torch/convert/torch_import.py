"""Import reference (PyTorch ``perceiver-io``) state_dicts into the port.
Counterpart of ``perceiver_io_tpu/convert/torch_import.py``: an
``import_*`` per task model, each returning the port model's
``state_dict`` (fp32 tensors on the CPU; load it with
``load_state_dict(strict=True)``).

The port's parameter names are the JAX package's flax paths
(:mod:`.from_jax`), and its linear weights are stored ``(out, in)`` as the
reference stores them, so the conversion only renames. The module map of a
task (:func:`module_map`) pairs each port module with its reference
module; :mod:`.export` reads the same map the other way.

==============================  =======================================
reference (torch)               port
==============================  =======================================
``TrainableQueryProvider._query``  ``TrainableQueryProvider.query``
``Sequential`` indices (0/1/3)  named modules (``norm``/``hidden``/``out``)
``Residual.module`` wrapper     (transparent)
``<block>.<i>``                 ``<block>.layers.<i>``
``0.`` / ``1.`` (``PerceiverIO``)  ``encoder.`` / ``decoder.``
==============================  =======================================
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, Mapping

import numpy as np
import torch

_PROJECTIONS = ("q_proj", "k_proj", "v_proj", "o_proj")
_SUFFIXES = (".weight", ".bias")


def _tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32).clone()
    return torch.tensor(np.asarray(x), dtype=torch.float32)


def _strip_wrappers(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    """Drop fairscale checkpoint-wrapper name fragments and name the
    reference ``PerceiverIO`` Sequential's indices (``0.`` encoder, ``1.``
    decoder)."""
    out = {}
    for k, v in state_dict.items():
        k = k.replace("_checkpoint_wrapped_module.", "")
        if k.startswith("0."):
            k = "encoder." + k[2:]
        elif k.startswith("1."):
            k = "decoder." + k[2:]
        out[k] = v
    return out


def _attention_layer(port: str, ref: str, *, cross: bool, residual: bool = True) -> Dict[str, str]:
    """A cross- or self-attention layer: the reference's
    ``Sequential(Residual(attention) | attention, Residual(MLP))``, its MLP
    ``Sequential(LayerNorm, Linear, GELU, Linear)``."""
    pre = f"{ref}.0.module" if residual else f"{ref}.0"
    kind = "cross_attn" if cross else "self_attn"
    norms = ("q_norm", "kv_norm") if cross else ("norm",)
    m = {f"{port}.{kind}.{n}": f"{pre}.{n}" for n in norms}
    m.update({f"{port}.{kind}.attention.{p}": f"{pre}.attention.{p}" for p in _PROJECTIONS})
    m.update({f"{port}.mlp.norm": f"{ref}.1.module.0", f"{port}.mlp.hidden": f"{ref}.1.module.1",
              f"{port}.mlp.out": f"{ref}.1.module.3"})
    return m


def _self_attention_block(port: str, ref: str, num_layers: int) -> Dict[str, str]:
    m = {}
    for i in range(num_layers):
        m.update(_attention_layer(f"{port}.layers.{i}", f"{ref}.{i}", cross=False))
    return m


def _encoder(ref: str, config) -> Dict[str, str]:
    """The Perceiver IO encoder without its input adapter; the unshared
    ``*_n`` towers where the config asks for them."""
    c = config
    m = {"encoder.latent_provider.query": f"{ref}.latent_provider._query"}
    m.update(_attention_layer("encoder.cross_attn_1", f"{ref}.cross_attn_1", cross=True))
    m.update(_self_attention_block("encoder.self_attn_1", f"{ref}.self_attn_1",
                                   c.num_self_attention_layers_per_block))
    if c.num_cross_attention_layers > 1 and not c.first_cross_attention_layer_shared:
        m.update(_attention_layer("encoder.cross_attn_n", f"{ref}.cross_attn_n", cross=True))
    if c.num_self_attention_blocks > 1 and not c.first_self_attention_block_shared:
        m.update(_self_attention_block("encoder.self_attn_n", f"{ref}.self_attn_n",
                                       c.num_self_attention_layers_per_block))
    return m


def _decoder(ref: str, config) -> Dict[str, str]:
    residual = getattr(config, "cross_attention_residual", True)
    return _attention_layer("decoder.cross_attn", f"{ref}.cross_attn", cross=True, residual=residual)


def _text_adapter(port: str, ref: str) -> Dict[str, str]:
    return {f"{port}.txt_embedding": f"{ref}.txt_embedding", f"{port}.pos_embedding": f"{ref}.pos_embedding"}


#: port modules an import may find absent: the text adapters' position
#: embedding (``abs_pos_emb=False``) and the tied MLM head's bias
OPTIONAL = ("encoder.input_adapter.pos_embedding", "perceiver_ar.input_adapter.pos_embedding",
            "decoder.output_adapter")


def module_map(task: str, config, encoder: str = "encoder", decoder: str = "decoder") -> Dict[str, str]:
    """Port module (or bare parameter) -> reference module of ``task``'s
    model under ``config`` (tasks as :data:`.export.TASKS`: ``"clm"``,
    ``"sam"``, ``"mlm"``, ``"txt-clf"``, ``"img-clf"``, ``"flow"``).
    ``encoder`` / ``decoder`` are the reference's prefixes of a Perceiver IO
    model's halves (``"0"`` / ``"1"`` in its ``PerceiverIO`` Sequential)."""
    if task not in ("clm", "sam", "mlm", "txt-clf", "img-clf", "flow"):
        raise ValueError(f"unknown task {task!r}")
    if task in ("clm", "sam"):
        m = {"perceiver_ar.input_adapter.txt_embedding": "input_adapter.txt_embedding"}
        if config.abs_pos_emb:
            m["perceiver_ar.input_adapter.pos_embedding"] = "input_adapter.pos_embedding"
        m.update(_attention_layer("perceiver_ar.cross_attention", "cross_attention", cross=True))
        m.update(_self_attention_block("perceiver_ar.self_attention", "self_attention",
                                       config.num_self_attention_layers))
        if config.output_norm:
            m["out_norm"] = "out_norm"
        if config.output_bias:
            m["output_adapter.bias"] = "output_adapter.bias"
        return m
    m = _encoder(encoder, config.encoder)
    m.update(_decoder(decoder, config.decoder))
    if task in ("mlm", "txt-clf"):
        m.update(_text_adapter("encoder.input_adapter", f"{encoder}.input_adapter"))
    if task in ("mlm", "txt-clf", "img-clf"):
        m["decoder.output_query_provider.query"] = f"{decoder}.output_query_provider._query"
    if task == "mlm" and config.decoder.num_output_query_channels is None:
        m["decoder.output_adapter"] = f"{decoder}.output_adapter"  # the tied head's bias
    else:
        m["decoder.output_adapter.linear"] = f"{decoder}.output_adapter.linear"
    if task == "flow":
        m["encoder.input_adapter.linear"] = f"{encoder}.input_adapter.linear"
    return m


def rename(sd: Mapping[str, Any], mapping: Mapping[str, str], optional: Iterable[str] = ()) -> Dict[str, Any]:
    """``sd``'s entries under ``mapping``'s module renames: a bare parameter
    by its own name, a module by its ``.weight`` and ``.bias``. A module of
    ``mapping`` with no entry in ``sd`` raises ``KeyError`` unless it is in
    ``optional``."""
    out: Dict[str, Any] = {}
    for src, dst in mapping.items():
        if src in sd:
            out[dst] = sd[src]
            continue
        found = [s for s in _SUFFIXES if src + s in sd]
        if not found and src not in optional:
            raise KeyError(f"{src} (.weight/.bias) not in the state dict")
        for s in found:
            out[dst + s] = sd[src + s]
    return out


def _import(task: str, state_dict: Mapping[str, Any], config) -> Dict[str, torch.Tensor]:
    sd = _strip_wrappers(state_dict)
    to_port = {ref: port for port, ref in module_map(task, config).items()}
    optional = [ref for ref, port in to_port.items() if port in OPTIONAL]
    return {k: _tensor(v) for k, v in rename(sd, to_port, optional).items()}


def import_masked_language_model(state_dict: Mapping[str, Any], config) -> Dict[str, torch.Tensor]:
    """Reference ``MaskedLanguageModel`` state_dict -> the port's
    :class:`~perceiver_io_tpu_torch.models.text.mlm.MaskedLanguageModel`."""
    return _import("mlm", state_dict, config)


def import_text_classifier(state_dict: Mapping[str, Any], config) -> Dict[str, torch.Tensor]:
    """Reference ``TextClassifier`` state_dict -> the port's ``TextClassifier``."""
    return _import("txt-clf", state_dict, config)


def import_image_classifier(state_dict: Mapping[str, Any], config) -> Dict[str, torch.Tensor]:
    """Reference ``ImageClassifier`` state_dict -> the port's
    ``ImageClassifier`` (its input adapter holds no parameters: the
    reference's Fourier buffer is not read)."""
    return _import("img-clf", state_dict, config)


def import_optical_flow(state_dict: Mapping[str, Any], config) -> Dict[str, torch.Tensor]:
    """Reference ``OpticalFlow`` state_dict -> the port's ``OpticalFlow``."""
    return _import("flow", state_dict, config)


def import_causal_language_model(state_dict: Mapping[str, Any], config) -> Dict[str, torch.Tensor]:
    """Reference ``CausalLanguageModel`` state_dict (flat ``PerceiverAR``
    layout) -> the port's ``CausalLanguageModel`` (``perceiver_ar``-nested;
    the rotary ``inv_freq`` buffer is not read)."""
    return _import("clm", state_dict, config)


def import_symbolic_audio_model(state_dict: Mapping[str, Any], config) -> Dict[str, torch.Tensor]:
    """Reference ``SymbolicAudioModel`` state_dict -> the port's
    ``SymbolicAudioModel``."""
    return _import("sam", state_dict, config)
