"""Validation-time qualitative callbacks. Counterpart of
``perceiver_io_tpu/training/callbacks.py``: :class:`TextSamplingCallback`
samples a continuation from the current weights after every validation pass
and logs it through :meth:`Trainer.log_text`; :class:`MaskFillingCallback`
fills masked samples (the masked-LM family).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch


class TextSamplingCallback:
    """Sample a continuation of ``prompt`` after every validation pass
    (causal-LM family), with the port's ``generate()``.

    The sampling generator is seeded from ``(seed, step)`` on the model's
    device: a pure function of the step, as JAX's
    ``fold_in(PRNGKey(seed), step)``, but a different stream, so sampled text
    matches JAX's only where sampling is deterministic (``top_k=1``)."""

    def __init__(self, model, tokenizer, prompt: str = "A man", *, max_new_tokens: int = 128,
                 num_latents: int = 64, top_k: Optional[int] = 40, seed: int = 0):
        self.model = model
        self.tokenizer = tokenizer
        self.prompt = prompt
        self.max_new_tokens = max_new_tokens
        self.num_latents = num_latents
        self.top_k = top_k
        self.seed = seed

    def __call__(self, trainer, state, step: int, val_metrics: dict) -> None:
        from perceiver_io_tpu_torch.inference.generate import GenerationConfig, generate
        from perceiver_io_tpu_torch.inference.samplers import SamplingConfig
        from perceiver_io_tpu_torch.training.trainer import step_generator

        device = self.model.device
        ids = np.asarray([self.tokenizer.encode(self.prompt)], np.int32)
        config = GenerationConfig(
            max_new_tokens=self.max_new_tokens,
            num_latents=min(self.num_latents, ids.shape[1]),
            pad_token_id=self.tokenizer.pad_token_id or 0,
            eos_token_id=self.tokenizer.eos_token_id,
            sampling=SamplingConfig(do_sample=True, top_k=self.top_k),
        )
        with torch.no_grad():
            out = generate(self.model, ids, config, generator=step_generator(self.seed, step, device),
                           device=device)
        text = self.prompt + self.tokenizer.decode(out[0].cpu().tolist())
        trainer.log_text(step, "samples/generated", text)


class MaskFillingCallback:
    """Fill masked validation samples after every validation pass (masked-LM
    family); logs the top-k fillings of each sample."""

    def __init__(self, model, preprocessor, masked_samples: Sequence[str], *, top_k: int = 3):
        self.model = model
        self.preprocessor = preprocessor
        self.masked_samples = list(masked_samples)
        self.top_k = top_k

    def __call__(self, trainer, state, step: int, val_metrics: dict) -> None:
        from perceiver_io_tpu_torch.inference.mask_filler import MaskFiller

        _, filled = MaskFiller(self.preprocessor).fill(self.model, self.masked_samples, self.top_k)
        for sample, fillings in zip(self.masked_samples, filled):
            trainer.log_text(step, "samples/fill_mask", f"{sample!r} -> {fillings}")
