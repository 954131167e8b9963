"""Hyperparameter dataclasses of the core Perceiver modules, with the JAX
package's field names (``perceiver_io_tpu/models/core/config.py``), so a
config dict (:func:`config_to_dict`) round-trips between the two packages.

- :class:`EncoderConfig` / :class:`DecoderConfig` /
  :class:`ClassificationDecoderConfig`, paired by :class:`PerceiverIOConfig`
  (the Perceiver IO families; the concrete encoder and decoder classes are
  recorded under ``"_type"``);
- :class:`PerceiverARConfig`: the dropout rates (prefix, attention and
  residual) act in train mode; ``activation_checkpointing`` recomputes every
  layer in the backward and ``activation_offloading`` moves the layers'
  saved inputs to pinned host memory (``models/core/modules.remat``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import asdict, dataclass, fields
from typing import Any, Dict, Generic, Optional, TypeVar


@dataclass
class EncoderConfig:
    """Perceiver IO encoder hyperparameters."""

    num_cross_attention_heads: int = 8
    num_cross_attention_qk_channels: Optional[int] = None
    num_cross_attention_v_channels: Optional[int] = None
    num_cross_attention_layers: int = 1
    first_cross_attention_layer_shared: bool = False
    cross_attention_widening_factor: int = 1
    num_self_attention_heads: int = 8
    num_self_attention_qk_channels: Optional[int] = None
    num_self_attention_v_channels: Optional[int] = None
    num_self_attention_layers_per_block: int = 8
    num_self_attention_blocks: int = 1
    first_self_attention_block_shared: bool = True
    self_attention_widening_factor: int = 1
    dropout: float = 0.0
    init_scale: float = 0.02
    freeze: bool = False

    def base_kwargs(self, exclude=("freeze",)) -> Dict[str, Any]:
        return _base_kwargs(self, EncoderConfig, exclude)


@dataclass
class DecoderConfig:
    """Perceiver IO decoder hyperparameters."""

    num_cross_attention_heads: int = 8
    num_cross_attention_qk_channels: Optional[int] = None
    num_cross_attention_v_channels: Optional[int] = None
    cross_attention_widening_factor: int = 1
    cross_attention_residual: bool = True
    dropout: float = 0.0
    init_scale: float = 0.02
    freeze: bool = False

    def base_kwargs(self, exclude=("freeze",)) -> Dict[str, Any]:
        return _base_kwargs(self, DecoderConfig, exclude)


@dataclass
class ClassificationDecoderConfig(DecoderConfig):
    num_output_queries: int = 1
    num_output_query_channels: int = 256
    num_classes: int = 100


E = TypeVar("E", bound=EncoderConfig)
D = TypeVar("D", bound=DecoderConfig)


@dataclass
class PerceiverIOConfig(Generic[E, D]):
    """An encoder config and a decoder config, with the latent array's
    shape. ``activation_checkpointing`` recomputes the attention layers in
    the backward; ``activation_offloading`` moves their saved inputs to
    pinned host memory."""

    encoder: E
    decoder: D
    num_latents: int
    num_latent_channels: int
    activation_checkpointing: bool = False
    activation_offloading: bool = False


@dataclass
class PerceiverARConfig:
    num_heads: int = 8
    max_heads_parallel: Optional[int] = None
    num_self_attention_layers: int = 8
    self_attention_widening_factor: int = 4
    cross_attention_widening_factor: int = 4
    cross_attention_dropout: float = 0.5
    post_attention_dropout: float = 0.0
    residual_dropout: float = 0.0
    activation_checkpointing: bool = False
    activation_offloading: bool = False

    def base_kwargs(self, exclude=()) -> Dict[str, Any]:
        return _base_kwargs(self, PerceiverARConfig, exclude)


def _base_kwargs(config, base_class, exclude) -> Dict[str, Any]:
    names = [f.name for f in fields(base_class) if f.name not in exclude]
    return {k: v for k, v in asdict(config).items() if k in names}


#: config dataclasses by class name, for nested configs whose field type is
#: a TypeVar (:class:`PerceiverIOConfig`): :func:`config_to_dict` records the
#: concrete class under ``"_type"``
_CONFIG_REGISTRY: Dict[str, type] = {}


def register_config(cls):
    """Class decorator: make a config dataclass round-trippable through
    :func:`config_to_dict` / :func:`config_from_dict`."""
    _CONFIG_REGISTRY[cls.__name__] = cls
    return cls


for _cls in (EncoderConfig, DecoderConfig, ClassificationDecoderConfig, PerceiverIOConfig, PerceiverARConfig):
    register_config(_cls)


def config_to_dict(config) -> Any:
    """A (possibly nested) config dataclass as plain dicts, each with its
    class name under ``"_type"`` (the JAX package's format)."""
    if dataclasses.is_dataclass(config):
        d = {f.name: config_to_dict(getattr(config, f.name)) for f in fields(config)}
        d["_type"] = type(config).__name__
        return d
    if isinstance(config, (list, tuple)):
        return [config_to_dict(v) for v in config]
    return config


def config_from_dict(cls, d: Dict[str, Any]):
    """The config dataclass of :func:`config_to_dict`'s output. ``cls`` is
    the expected class; an embedded ``"_type"`` naming a registered class
    takes precedence (the model modules register theirs when imported, and
    an unknown name imports them all once)."""
    type_name = d.get("_type", "")
    if type_name and type_name not in _CONFIG_REGISTRY:
        from perceiver_io_tpu_torch.models import import_task_modules

        import_task_modules()
    target = _CONFIG_REGISTRY.get(type_name, cls)
    if target is None:
        raise ValueError(f"unknown config type {type_name!r} (not registered)")
    kwargs = {}
    for f in fields(target):
        if f.name not in d:
            continue
        v = d[f.name]
        if isinstance(v, dict) and "_type" in v:
            kwargs[f.name] = config_from_dict(None, v)
        else:
            kwargs[f.name] = tuple(v) if isinstance(v, list) else v
    return target(**kwargs)
