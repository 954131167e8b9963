"""Top-k mask filling for masked language models. Counterpart of
``perceiver_io_tpu/inference/mask_filler.py``: every ``<mask>`` token is
replaced with its k-th most likely prediction and the batch decoded, giving
k filled variants of each input text."""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch


class MaskFiller:
    """:param preprocessor: a text preprocessor with ``tokenizer`` and
    ``preprocess_batch(texts) -> (input_ids, pad_mask)`` (numpy arrays), e.g.
    :class:`perceiver_io_tpu_torch.data.text.TextPreprocessor`."""

    def __init__(self, preprocessor):
        self.preprocessor = preprocessor

    def fill(self, model, masked_text_batch: Sequence[str],
             num_predictions: int) -> Tuple[List[str], List[List[str]]]:
        """``(masked texts, [k fillings per text])``. The model runs on its
        own device; the top-k is taken on the host with JAX's
        ``np.argsort(-logits)``, so ties break as they do there."""
        tokenizer = self.preprocessor.tokenizer
        masked_text_batch = [ms.replace("<mask>", tokenizer.mask_token) for ms in masked_text_batch]
        xs, pad_mask = self.preprocessor.preprocess_batch(masked_text_batch)
        xs = np.asarray(xs)
        device = model.device
        with torch.no_grad():
            logits = model(torch.as_tensor(xs, dtype=torch.long, device=device),
                           pad_mask=torch.as_tensor(np.asarray(pad_mask), device=device))
        logits = logits.float().cpu().numpy()

        pred_mask = xs == tokenizer.mask_token_id
        # top-k prediction ids per masked position, most likely first
        pred_ids = np.argsort(-logits[pred_mask, :], axis=-1)[:, :num_predictions]

        results = []
        filled = xs.copy()
        for i in range(num_predictions):
            filled[pred_mask] = pred_ids[:, i]
            results.append(tokenizer.batch_decode(filled, skip_special_tokens=True))
        return masked_text_batch, list(map(list, zip(*results)))
