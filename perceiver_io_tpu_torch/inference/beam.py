"""Beam search decoding for Perceiver AR sequence models. Counterpart of
``perceiver_io_tpu/inference/beam.py``, with HF ``GenerationMixin`` beam
semantics over the same right-aligned static window as :mod:`.generate`:

- beams ride the batch axis (``b·k`` windows); scores start
  ``[0, -1e9, ...]`` so step 1 fans out of beam 0;
- a step is one full :func:`~.generate._decode_forward` (no cache, as in
  JAX), ``log_softmax``, the repetition penalty on the log-probs, the
  ``min_new_tokens`` EOS mask, then the top ``2k`` of the ``(b, k·V)``
  cumulative scores;
- EOS candidates among the first ``k`` enter a per-row hypothesis pool of
  ``k``, best first, each evicting the worst, scored
  ``score / (t + 1)**length_penalty`` (generated tokens only, as the
  vectorised ``_beam_search`` of transformers >= 4.50); the first ``k``
  non-EOS candidates continue;
- after ``max_new_tokens`` steps the live beams, scored
  ``score / max_new_tokens**length_penalty``, join the pool and the best
  sequence wins (``early_stopping=False``).

Where JAX runs one ``lax.scan``, the port runs a Python loop whose step
stays on the device: no host read inside it. ``jax.lax.top_k`` puts the
lower index first on equal scores and ``torch.topk`` promises no order, so
the candidates come from a stable descending sort.
"""
from __future__ import annotations

import numpy as np
import torch

from perceiver_io_tpu_torch._device import DeviceLike, resolve_device
from perceiver_io_tpu_torch.inference.generate import (
    GenerationConfig,
    _decode_forward,
    _on_device,
)
from perceiver_io_tpu_torch.inference.samplers import (
    apply_min_new_tokens,
    apply_repetition_penalty,
    true_div,
)

NEG_INF = -1e9


def beam_search(model, input_ids, config: GenerationConfig, *, num_beams: int = 3,
                length_penalty: float = 1.0, prompt_pad_count=None,
                device: DeviceLike = "cuda") -> torch.Tensor:
    """Beam-search ``config.max_new_tokens`` tokens after ``input_ids``.

    :param input_ids: ``(b, prompt_len)`` prompt, left-padded if ragged.
    :param prompt_pad_count: ``(b,)`` left-pad counts for ragged prompts.
    :return: ``(b, max_new_tokens)`` ids of the best beam (pad after EOS).
    """
    dev = resolve_device(device)
    if not _on_device(model, dev):
        raise ValueError(f"model lies on {model.device}, beam_search was asked for {dev}")
    input_ids = torch.as_tensor(input_ids, device=dev)
    b, prompt_len = input_ids.shape
    n = model.max_seq_len
    max_latents = model.max_latents
    if not 0 < prompt_len <= n:
        raise ValueError(f"prompt length out of valid range [1..{n}]")
    if not 0 < config.num_latents <= max_latents:
        raise ValueError(f"num_latents={config.num_latents} out of valid range [1..{max_latents}]")
    num_latents = min(prompt_len, config.num_latents)
    prefix_len = prompt_len - num_latents
    if prefix_len > model.max_prefix_len:
        raise ValueError(
            f"for sequence length {prompt_len}, num_latents must be >= "
            f"{num_latents + prefix_len - model.max_prefix_len}"
        )
    if prompt_pad_count is None:
        pad = torch.zeros((b,), dtype=torch.long, device=dev)
    else:
        pad = torch.as_tensor(np.asarray(torch.as_tensor(prompt_pad_count).cpu(), np.int64),
                              device=dev)
    with torch.no_grad():
        return _run(model, config, input_ids, pad, num_latents, int(num_beams),
                    float(length_penalty))


def _run(model, config: GenerationConfig, input_ids, prompt_pad_count, num_latents: int,
         k: int, length_penalty: float) -> torch.Tensor:
    b, prompt_len = input_ids.shape
    n = model.max_seq_len
    max_latents = model.max_latents
    dev = input_ids.device
    t_max = config.max_new_tokens
    vocab = model.config.vocab_size
    eos = config.eos_token_id
    min_new = min(config.min_new_tokens, t_max) if eos is not None else t_max
    rep_penalty = config.sampling.repetition_penalty
    pad_id = config.pad_token_id

    # beams ride the batch axis: (b, k, ...) flattened to (b*k, ...)
    window = torch.full((b, n), pad_id, dtype=input_ids.dtype, device=dev)
    window[:, n - prompt_len:] = input_ids
    window = window.repeat_interleave(k, dim=0)
    pad_count = (prompt_pad_count + (n - prompt_len)).repeat_interleave(k, dim=0)
    beam_scores = torch.full((b, k), NEG_INF, dtype=torch.float32, device=dev)
    beam_scores[:, 0] = 0.0
    # pad-filled: a finished hypothesis's history is copied into the pool
    # wholesale, so its post-EOS slots must already hold pad
    tok_buf = torch.full((b, k, t_max), pad_id, dtype=torch.long, device=dev)
    hyp_scores = torch.full((b, k), float("-inf"), dtype=torch.float32, device=dev)
    hyp_tokens = torch.full((b, k, t_max), pad_id, dtype=torch.long, device=dev)
    rows = torch.arange(b, device=dev)
    rows_k = rows[:, None]
    first_k = torch.arange(2 * k, device=dev)[None, :] < k
    m = num_latents

    for t in range(t_max):
        logits = _decode_forward(model, window, pad_count, m)  # (b*k, V)
        logp = torch.log_softmax(logits.float(), dim=-1)
        if rep_penalty != 1.0:
            # HF beam order: processors run on the log-probs
            pads = torch.arange(n, device=dev)[None, :] < pad_count[:, None]
            logp = apply_repetition_penalty(logp, window, rep_penalty, pads)
        if eos is not None:
            logp = apply_min_new_tokens(logp, t, min_new, eos)
        scores = (beam_scores.reshape(b * k, 1) + logp).reshape(b, k * vocab)

        # the top 2k, best first, the lower index first on equal scores
        order = torch.sort(scores, dim=1, descending=True, stable=True)
        cand_scores, cand_idx = order.values[:, :2 * k], order.indices[:, :2 * k]
        cand_beam = cand_idx // vocab  # (b, 2k)
        cand_tok = cand_idx % vocab

        if eos is not None:
            is_eos = cand_tok == eos
            # EOS candidates among the first k enter the pool, best first,
            # each evicting the worst (HF BeamHypotheses.add); the length
            # norm in fp32 on the host, as JAX computes it traced
            denom = float(np.float32(t + 1.0) ** np.float32(length_penalty))
            hyp_cand = torch.where(is_eos & first_k, true_div(cand_scores, denom),
                                   torch.full_like(cand_scores, float("-inf")))
            for _ in range(k):
                best_e = torch.argmax(hyp_cand, dim=1)  # (b,)
                best_score = hyp_cand[rows, best_e]
                src_beam = cand_beam[rows, best_e]
                hist = tok_buf[rows, src_beam]  # (b, t_max), a copy
                hist[:, t] = eos
                worst = torch.argmin(hyp_scores, dim=1)  # (b,)
                worst_score = hyp_scores[rows, worst]
                replace = best_score > worst_score
                hyp_scores[rows, worst] = torch.where(replace, best_score, worst_score)
                hyp_tokens[rows, worst] = torch.where(replace[:, None], hist, hyp_tokens[rows, worst])
                hyp_cand[rows, best_e] = float("-inf")  # consumed
            # live beams: the first k non-EOS candidates, in candidate order
            live = torch.sort(is_eos.to(torch.int32), dim=1, stable=True).indices[:, :k]
        else:
            live = torch.arange(k, device=dev)[None, :].expand(b, k)

        beam_scores = torch.gather(cand_scores, 1, live)  # (b, k)
        new_beam = torch.gather(cand_beam, 1, live)
        new_tok = torch.gather(cand_tok, 1, live)

        # reindex the beam state, then advance the windows with the new tokens
        window = window.reshape(b, k, n)[rows_k, new_beam].reshape(b * k, n)
        pad_count = pad_count.reshape(b, k)[rows_k, new_beam].reshape(b * k)
        tok_buf = tok_buf[rows_k, new_beam]
        tok_buf[:, :, t] = new_tok
        window = torch.cat([window[:, 1:], new_tok.reshape(b * k, 1).to(window.dtype)], dim=1)
        pad_count = (pad_count - 1).clamp(min=0)
        m = min(m + 1, max_latents)

    # finalize (early_stopping=False at max length): live beams join the pool
    live_final = true_div(beam_scores, float(t_max) ** length_penalty)
    all_scores = torch.cat([hyp_scores, live_final], dim=1)  # (b, 2k)
    all_tokens = torch.cat([hyp_tokens, tok_buf], dim=1)  # (b, 2k, t_max)
    best = torch.argmax(all_scores, dim=1)
    return all_tokens[rows, best].to(input_ids.dtype)
