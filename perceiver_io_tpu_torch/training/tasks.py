"""Task loss functions: the training semantics of the reference's Lightning
wrappers as plain ``(model, batch, generator) -> (loss, metrics)``
functions for :func:`perceiver_io_tpu_torch.parallel.make_train_step`.

Counterpart of ``perceiver_io_tpu/training/tasks.py``; the model takes the
place of JAX's params and a ``torch.Generator`` that of the rng key (``None``
means deterministic). JAX splits its key into ``dropout`` and ``prefix``
streams; the port draws every kind of noise from the one generator in
forward order: the prefix-dropout scores first, then, layer by layer, the
attention keep-masks (one per head group), the attention branch's and the
MLP branch's residual masks. Batches are dicts of tensors with the reference's
collator fields (``input_ids``, ``labels``, optional ``pad_mask``; the
vision data modules' ``image`` and ``label``).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from perceiver_io_tpu_torch.parallel.collectives import batch_mean, reducing

IGNORE_INDEX = -100  # torch cross_entropy's ignore_index, used throughout the reference

LossFn = Callable[[nn.Module, Dict[str, torch.Tensor], Optional[torch.Generator]],
                  Tuple[torch.Tensor, Dict[str, torch.Tensor]]]


def masked_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Token-mean cross entropy over the labels that are not
    ``IGNORE_INDEX``: fp32 log-softmax, the sum over valid labels divided by
    ``max(1, count)``; under a mesh the count is the global batch's
    (:func:`~perceiver_io_tpu_torch.parallel.collectives.batch_mean`)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    valid = labels != IGNORE_INDEX
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    return batch_mean(nll.sum(), valid.sum())


def clm_loss_fn(model: nn.Module, max_latents: int) -> LossFn:
    """Perceiver AR causal-LM step for ``model``: ``prefix_len = seq_len -
    max_latents``, pad labels set to ``IGNORE_INDEX``, the loss on the last
    ``max_latents`` positions only. The returned function takes the model
    (the train state's, the role of JAX's params) as its first argument."""
    if not 0 < max_latents <= model.max_latents:
        raise ValueError(f"max_latents must be in [1, {model.max_latents}], got {max_latents}")

    def loss_fn(model: nn.Module, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator]):
        input_ids, labels = batch["input_ids"], batch["labels"]
        pad_mask = batch.get("pad_mask")
        prefix_len = input_ids.shape[1] - max_latents
        if pad_mask is not None:
            labels = labels.masked_fill(pad_mask.bool(), IGNORE_INDEX)
        logits = model(input_ids, prefix_len, pad_mask=pad_mask,
                       deterministic=generator is None, generator=generator)
        return masked_cross_entropy(logits, labels[:, prefix_len:]), {}

    return loss_fn


def mlm_loss_fn(model: nn.Module) -> LossFn:
    """Masked-LM step: cross entropy over every position, the labels of
    unmasked positions ``IGNORE_INDEX`` (the collator's)."""

    def loss_fn(model: nn.Module, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator]):
        logits = model(batch["input_ids"], pad_mask=batch.get("pad_mask"),
                       deterministic=generator is None, generator=generator)
        return masked_cross_entropy(logits, batch["labels"]), {}

    return loss_fn


def _accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The share of rows whose argmax is their label, fp32 (over the global
    batch under a mesh)."""
    correct = (logits.argmax(dim=-1) == labels).float()
    return batch_mean(correct.sum(), correct.numel()) if reducing() else correct.mean()


def image_classifier_loss_fn(model: nn.Module) -> LossFn:
    """Image classifier step over ``{"image", "label"}`` batches (the vision
    data modules' contract): cross entropy and accuracy."""

    def loss_fn(model: nn.Module, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator]):
        logits = model(batch["image"], deterministic=generator is None, generator=generator)
        labels = batch["label"]
        return masked_cross_entropy(logits, labels), {"accuracy": _accuracy(logits, labels)}

    return loss_fn


def classifier_loss_fn(model: nn.Module) -> LossFn:
    """Text classifier step over ``{"input_ids", "labels", "pad_mask"}``
    batches: cross entropy and accuracy."""

    def loss_fn(model: nn.Module, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator]):
        logits = model(batch["input_ids"], pad_mask=batch.get("pad_mask"),
                       deterministic=generator is None, generator=generator)
        labels = batch["labels"]
        return masked_cross_entropy(logits, labels), {"accuracy": _accuracy(logits, labels)}

    return loss_fn
