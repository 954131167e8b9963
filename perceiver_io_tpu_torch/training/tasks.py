"""Task loss functions: the training semantics of the reference's Lightning
wrappers as plain ``(model, batch, generator) -> (loss, metrics)``
functions for :func:`perceiver_io_tpu_torch.parallel.make_train_step`.

Counterpart of ``perceiver_io_tpu/training/tasks.py``; the model takes the
place of JAX's params and a ``torch.Generator`` that of the rng key (``None``
means deterministic). Batches are dicts of tensors with the reference's
collator fields (``input_ids``, ``labels``, optional ``pad_mask``). The MLM,
classifier and image loss functions are not ported yet.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

IGNORE_INDEX = -100  # torch cross_entropy's ignore_index, used throughout the reference

LossFn = Callable[[nn.Module, Dict[str, torch.Tensor], Optional[torch.Generator]],
                  Tuple[torch.Tensor, Dict[str, torch.Tensor]]]


def masked_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Token-mean cross entropy over the labels that are not
    ``IGNORE_INDEX``: fp32 log-softmax, the sum over valid labels divided by
    ``max(1, count)``."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    valid = labels != IGNORE_INDEX
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    return nll.sum() / valid.sum().clamp(min=1)


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
