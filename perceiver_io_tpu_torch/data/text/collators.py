"""Collators. A copy of ``perceiver_io_tpu/data/text/collators.py``: the
same seed gives the same batches and masks, because every draw comes from a
numpy ``Generator`` seeded as the JAX package seeds it.

Clf / CLM batches are padded to a **fixed** ``max_seq_len`` rather than the
batch max (the reference pads to the longest example per batch,
``perceiver/data/text/collator.py:53-56``), so every training step has one
shape.

All collators emit dict batches ``{"labels", "input_ids", "pad_mask"}``
(int32 / int32 / bool, True at padding) — the dict form of the reference's
``(labels, input_ids, ~attention_mask)`` tuple protocol (``collator.py:20-22``).
Word ids ride along as int32 arrays with ``-1`` in place of the reference's
``None`` (special tokens).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

IGNORE_INDEX = -100
NO_WORD = -1


def _pad_rows(
    rows: Sequence[np.ndarray],
    width: int,
    pad_value: int,
    padding_side: str,
) -> tuple[np.ndarray, np.ndarray]:
    """Pad/truncate 1-D int rows to ``width``; returns (array, pad_mask)."""
    out = np.full((len(rows), width), pad_value, dtype=np.int32)
    mask = np.ones((len(rows), width), dtype=bool)
    for i, row in enumerate(rows):
        row = np.asarray(row, dtype=np.int32)[:width]
        n = len(row)
        if padding_side == "left":
            out[i, width - n :] = row
            mask[i, width - n :] = False
        else:
            out[i, :n] = row
            mask[i, :n] = False
    return out, mask


class DefaultCollator:
    """Pad-to-``max_seq_len`` collator for clf / clm-view batches (reference
    ``DefaultCollator``, ``collator.py:44-85``). Labels priority: per-token
    ``label_ids`` (CLM shift view) > scalar ``label`` (classification) >
    all-ignore."""

    def __init__(self, tokenizer, max_seq_len: int):
        self.tokenizer = tokenizer
        self.max_seq_len = max_seq_len

    def __call__(self, examples: Sequence[Dict]) -> Dict[str, np.ndarray]:
        side = self.tokenizer.padding_side
        pad_id = self.tokenizer.pad_token_id or 0
        ids, pad_mask = _pad_rows(
            [e["input_ids"] for e in examples], self.max_seq_len, pad_id, side
        )
        if "label_ids" in examples[0]:
            labels, _ = _pad_rows(
                [e["label_ids"] for e in examples], self.max_seq_len, IGNORE_INDEX, side
            )
            labels = np.where(pad_mask, IGNORE_INDEX, labels)
        elif "label" in examples[0]:
            labels = np.asarray([e["label"] for e in examples], dtype=np.int32)
        else:
            labels = np.where(pad_mask, IGNORE_INDEX, ids)
        return {"labels": labels, "input_ids": ids, "pad_mask": pad_mask}


class WordMaskingCollator:
    """Whole-word masking (reference ``WordMaskingCollator``,
    ``collator.py:88-144``): select words with ``mask_prob``; replace the
    selected word's tokens with [MASK] (80%), random tokens (10%), or leave
    them (10%); labels are the original ids at selected positions and
    ``IGNORE_INDEX`` elsewhere. The 80/10/10 draw is per *word* (both random
    numbers drawn once per word, exactly the reference's branching)."""

    def __init__(self, tokenizer, mask_prob: float = 0.15, seed: Optional[int] = None):
        self.tokenizer = tokenizer
        self.mask_prob = mask_prob
        self.rng = np.random.default_rng(seed)

    def mask_example(
        self, input_ids: np.ndarray, word_ids: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray]:
        input_ids = np.asarray(input_ids, dtype=np.int32).copy()
        word_ids = np.asarray(word_ids)
        labels = np.full_like(input_ids, IGNORE_INDEX)

        # Group consecutive equal word ids into words (ids need not be
        # globally unique — only distinct between adjacent words).
        words: List[np.ndarray] = []
        start = None
        for i in range(len(word_ids) + 1):
            boundary = (
                i == len(word_ids)
                or word_ids[i] == NO_WORD
                or (start is not None and word_ids[i] != word_ids[start])
            )
            if boundary:
                if start is not None:
                    words.append(np.arange(start, i))
                start = None if i == len(word_ids) or word_ids[i] == NO_WORD else i
            elif start is None:
                start = i
        if start is not None:
            words.append(np.arange(start, len(word_ids)))

        if words:
            select = self.rng.binomial(1, self.mask_prob, len(words)).astype(bool)
            for word, sel in zip(words, select):
                if not sel:
                    continue
                r_mask, r_rand = self.rng.random(2)
                labels[word] = input_ids[word]
                if r_mask < 0.8:
                    input_ids[word] = self.tokenizer.mask_token_id
                elif r_rand < 0.5:
                    input_ids[word] = self.rng.integers(
                        0, self.tokenizer.vocab_size, size=len(word)
                    )
        return input_ids, labels

    def __call__(self, examples: Sequence[Dict]) -> Dict[str, np.ndarray]:
        masked = []
        for e in examples:
            ids, labels = self.mask_example(e["input_ids"], e["word_ids"])
            masked.append({"input_ids": ids, "label_ids": labels})
        side = self.tokenizer.padding_side
        width = max(len(e["input_ids"]) for e in masked)
        ids, pad_mask = _pad_rows(
            [e["input_ids"] for e in masked], width, self.tokenizer.pad_token_id or 0, side
        )
        labels, _ = _pad_rows([e["label_ids"] for e in masked], width, IGNORE_INDEX, side)
        return {"labels": labels, "input_ids": ids, "pad_mask": pad_mask}


class TokenMaskingCollator:
    """Per-token BERT masking (reference ``TokenMaskingCollator`` wrapping HF's
    ``DataCollatorForLanguageModeling``, ``collator.py:147-152``): each token
    independently selected with ``mask_prob``; of selected, 80% → [MASK],
    10% → random, 10% unchanged."""

    def __init__(self, tokenizer, mask_prob: float = 0.15, seed: Optional[int] = None):
        self.tokenizer = tokenizer
        self.mask_prob = mask_prob
        self.rng = np.random.default_rng(seed)

    def __call__(self, examples: Sequence[Dict]) -> Dict[str, np.ndarray]:
        side = self.tokenizer.padding_side
        width = max(len(e["input_ids"]) for e in examples)
        ids, pad_mask = _pad_rows(
            [e["input_ids"] for e in examples], width, self.tokenizer.pad_token_id or 0, side
        )
        labels = np.full_like(ids, IGNORE_INDEX)
        select = (self.rng.random(ids.shape) < self.mask_prob) & ~pad_mask
        labels[select] = ids[select]
        r = self.rng.random(ids.shape)
        ids = np.where(select & (r < 0.8), self.tokenizer.mask_token_id, ids)
        rand_ids = self.rng.integers(0, self.tokenizer.vocab_size, ids.shape)
        ids = np.where(select & (r >= 0.8) & (r < 0.9), rand_ids, ids).astype(np.int32)
        return {"labels": labels, "input_ids": ids, "pad_mask": pad_mask}


class RandomTruncateCollator:
    """Random tail truncation to length ≥ ``min_seq_len`` (reference
    ``RandomTruncateCollator``, ``collator.py:25-41``). Instead of
    shrinking the batch width, the dropped tail is *converted to padding* — input ids → pad, pad_mask → True,
    labels → ignore — so the model sees the truncated sequence while the
    batch shape stays static."""

    def __init__(self, collator, min_seq_len: int, seed: Optional[int] = None):
        self.collator = collator
        self.min_seq_len = min_seq_len
        self.rng = np.random.default_rng(seed)

    def __call__(self, examples: Sequence[Dict]) -> Dict[str, np.ndarray]:
        batch = self.collator(examples)
        seq_len = batch["input_ids"].shape[1]
        if seq_len <= self.min_seq_len:
            return batch
        drop = int(self.rng.integers(1, seq_len - self.min_seq_len + 1))
        pad_id = getattr(self.collator, "tokenizer").pad_token_id or 0
        batch["input_ids"][:, seq_len - drop :] = pad_id
        batch["pad_mask"][:, seq_len - drop :] = True
        if batch["labels"].ndim == 2:
            batch["labels"][:, seq_len - drop :] = IGNORE_INDEX
        return batch
