"""Logit processing and greedy token choice. Counterpart of
``perceiver_io_tpu/inference/samplers.py``; sampling (``do_sample=True``)
is not ported yet and raises."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

import torch


@dataclass(frozen=True)
class SamplingConfig:
    #: sampling is not ported yet: True raises; temperature/top-k/top-p come with it
    do_sample: bool = False
    #: HF ``RepetitionPenaltyLogitsProcessor``: tokens already in the context
    #: get ``score/p`` (if positive) or ``score*p`` (if negative). 1.0 = off.
    repetition_penalty: float = 1.0


def apply_min_new_tokens(logits: torch.Tensor, t: Union[int, torch.Tensor], min_new: int,
                         eos_token_id: int) -> torch.Tensor:
    """EOS is unreachable until ``min_new`` tokens exist (HF
    ``MinNewTokensLengthLogitsProcessor``). ``t`` is the 0-based generation
    step: a host integer, or a ``(b, 1)`` tensor of per-row steps (the slot
    engine's rows sit at different steps)."""
    if min_new <= 0:
        return logits
    is_eos = torch.arange(logits.shape[-1], device=logits.device)[None, :] == eos_token_id
    return logits.masked_fill((t < min_new) & is_eos, float("-inf"))


def apply_repetition_penalty(logits: torch.Tensor, context_ids: torch.Tensor, penalty: float,
                             context_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Divide the (positive) logit of every token id in ``context_ids`` by
    ``penalty``, or multiply a negative one by it.

    :param context_mask: optional ``(b, n)``, True = ignore this position.
    """
    b, vocab = logits.shape
    ids = context_ids.long()
    if context_mask is not None:
        ids = torch.where(context_mask, torch.full_like(ids, vocab), ids)
    seen = torch.zeros((b, vocab + 1), dtype=torch.bool, device=logits.device)
    seen.scatter_(1, ids, True)
    seen = seen[:, :vocab]
    penalized = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(seen, penalized, logits)


def sample_logits(logits: torch.Tensor, config: SamplingConfig,
                  context_ids: Optional[torch.Tensor] = None,
                  context_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``(b, vocab)`` logits -> ``(b,)`` token ids: greedy ``argmax`` (the
    first index on ties, as ``jnp.argmax``)."""
    if config.do_sample:
        raise NotImplementedError("sampling (do_sample=True) is not ported yet; use greedy")
    logits = logits.float()
    if config.repetition_penalty != 1.0 and context_ids is not None:
        logits = apply_repetition_penalty(
            logits, context_ids, config.repetition_penalty, context_mask
        )
    return torch.argmax(logits, dim=-1)
