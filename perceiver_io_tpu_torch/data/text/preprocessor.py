"""Inference-time text preprocessing. A copy of
``perceiver_io_tpu/data/text/preprocessor.py`` (reference ``TextPreprocessor``,
``perceiver/data/text/common.py:25-46``): text → (input_ids, pad_mask) with
pad_mask True at padding positions."""
from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np

from perceiver_io_tpu_torch.data.text.tokenizers import load_tokenizer


class TextPreprocessor:
    def __init__(self, tokenizer, max_seq_len: int, add_special_tokens: bool = False):
        if isinstance(tokenizer, str):
            tokenizer = load_tokenizer(tokenizer)
        self.tokenizer = tokenizer
        self.max_seq_len = max_seq_len
        self.add_special_tokens = add_special_tokens

    def preprocess(self, text: str) -> Tuple[np.ndarray, np.ndarray]:
        ids, mask = self.preprocess_batch([text])
        return ids[0], mask[0]

    def preprocess_batch(
        self, texts: Sequence[str], pad_to_max: bool = False
    ) -> Tuple[np.ndarray, np.ndarray]:
        return self.tokenizer.encode_batch(
            list(texts),
            max_length=self.max_seq_len,
            add_special_tokens=self.add_special_tokens,
            pad_to_max=pad_to_max,
        )
