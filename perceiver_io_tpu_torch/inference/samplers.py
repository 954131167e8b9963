"""Logit samplers: greedy, temperature, top-k, nucleus (top-p). Counterpart
of ``perceiver_io_tpu/inference/samplers.py``.

Processors compose in HF's order: repetition penalty, then (sampling only)
temperature -> top-k -> top-p, then the draw. The draw is the Gumbel-max
trick, as ``jax.random.categorical`` computes it: ``argmax(logits + g)``
with ``g = -log(-log(U))`` and ``U`` uniform on ``[tiny, 1)``. ``U`` comes
from a ``torch.Generator``, so the same seed gives another stream than
JAX's threefry; :func:`gumbel_noise` is the one place a draw happens.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple, Union

import torch

NEG_INF = float(torch.finfo(torch.float32).min)
_TINY = float(torch.finfo(torch.float32).tiny)


def true_div(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` correctly rounded on every device, as JAX divides. (CUDA
    multiplies by the reciprocal of a host scalar, 1 ulp off for most ``d``;
    a divisor on ``x``'s device takes the true division.)"""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


@dataclass(frozen=True)
class SamplingConfig:
    do_sample: bool = False
    temperature: float = 1.0
    top_k: Optional[int] = None
    top_p: Optional[float] = None
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
    penalized = torch.where(logits > 0, true_div(logits, penalty), logits * penalty)
    return torch.where(seen, penalized, logits)


def apply_top_k(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Keep the k highest logits per row, set the rest to :data:`NEG_INF`.
    ``k`` is clamped to the vocabulary; ties at the k-th value are kept."""
    k = min(k, logits.shape[-1])
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return logits.masked_fill(logits < kth, NEG_INF)


def apply_top_p(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Nucleus filtering: keep the smallest set of tokens whose cumulative
    probability reaches ``p``; the most probable token always survives
    (even at ``p = 0``). The threshold is the smallest kept logit."""
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    sorted_keep = (cum - probs) < p
    sorted_keep[..., 0] = True
    kth = torch.where(sorted_keep, sorted_logits, torch.full_like(sorted_logits, float("inf")))
    kth = kth.min(dim=-1, keepdim=True).values
    return logits.masked_fill(logits < kth, NEG_INF)


def gumbel_noise(shape, generator: torch.Generator, device) -> torch.Tensor:
    """``(b, V)`` standard Gumbel noise in fp32 from ``generator``:
    ``-log(-log(U))``, ``U`` uniform on ``[tiny, 1)``. Every sampled token
    of the port draws here, once per decode step."""
    u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
    return -torch.log(-torch.log(u.clamp_(min=_TINY)))


def filter_logits(logits: torch.Tensor, config: SamplingConfig,
                  context_ids: Optional[torch.Tensor] = None,
                  context_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The processed fp32 logits a token is chosen from: the repetition
    penalty, then, when sampling, temperature, top-k and top-p."""
    logits = logits.float()
    if config.repetition_penalty != 1.0 and context_ids is not None:
        # processors run before the greedy argmax too (HF order)
        logits = apply_repetition_penalty(
            logits, context_ids, config.repetition_penalty, context_mask
        )
    if not config.do_sample:
        return logits
    if config.temperature != 1.0:
        logits = true_div(logits, config.temperature)
    if config.top_k is not None and config.top_k > 0:
        logits = apply_top_k(logits, config.top_k)
    if config.top_p is not None and config.top_p < 1.0:
        logits = apply_top_p(logits, config.top_p)
    return logits


def default_generator(device: torch.device) -> torch.Generator:
    """A generator on ``device`` seeded 0, as JAX defaults to ``PRNGKey(0)``."""
    return torch.Generator(device=device).manual_seed(0)


def sample_logits(logits: torch.Tensor, config: SamplingConfig,
                  context_ids: Optional[torch.Tensor] = None,
                  context_mask: Optional[torch.Tensor] = None, *,
                  generator: Optional[torch.Generator] = None,
                  rows: Optional[Tuple[int, int, int]] = None) -> torch.Tensor:
    """``(b, vocab)`` logits -> ``(b,)`` token ids. Greedy: ``argmax`` of
    the processed logits (the first index on ties, as ``jnp.argmax``).
    Sampling: ``argmax(filtered + g)`` with ``g`` one :func:`gumbel_noise`
    draw from ``generator``.

    :param context_ids: ``(b, n)`` token history for the repetition penalty.
    :param context_mask: ``(b, n)``, True = ignore this history position.
    :param rows: ``(lo, hi, total)``: the logits are rows ``[lo, hi)`` of a
        ``total``-row batch sharded over ranks; the draw is the whole
        batch's, of which these rows are kept, so each rank samples what one
        process would.
    """
    logits = filter_logits(logits, config, context_ids, context_mask)
    if config.do_sample:
        if generator is None:
            raise ValueError("do_sample=True needs a generator")
        if rows is None:
            noise = gumbel_noise(logits.shape, generator, logits.device)
        else:
            noise = gumbel_noise((rows[2], logits.shape[-1]), generator, logits.device)[rows[0]:rows[1]]
        logits = logits + noise
    return torch.argmax(logits, dim=-1)
