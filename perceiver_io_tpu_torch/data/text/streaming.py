"""Streaming text pipeline. A copy of ``perceiver_io_tpu/data/text/streaming.py``,
the reference's C4 path (``perceiver/data/text/c4.py:20-164``) rebuilt
host-side:

source iterator → per-host shard → window shuffle → tokenize → concatenate
with EOS separators → chunk to ``max_seq_len + 1`` → batch → shift-by-one.

Differences from the reference:

- sharding uses ``(shard_index, shard_count)`` (by default this process's
  ``torch.distributed`` rank and world size, ``data.loader.host_shard_info``)
  instead of ``torch.distributed`` rank (``c4.py:56-79``);
- chunks are emitted at a **fixed** width; the ``min_seq_len`` randomization
  (``c4.py:100-104``) keeps static batch shapes by masking the tail to
  padding instead of emitting ragged chunks;
- batches are dict-of-NumPy ``{"labels", "input_ids", "pad_mask"}`` — the
  shift-by-one happens here, like ``C4Collator`` (``c4.py:156-164``).
"""
from __future__ import annotations

import random
import time
from typing import Callable, Dict, Iterable, Iterator, Optional

import numpy as np

from perceiver_io_tpu_torch.data.loader import host_shard_info
from perceiver_io_tpu_torch.data.text.collators import IGNORE_INDEX
from perceiver_io_tpu_torch.data.text.tokenizers import load_tokenizer
from perceiver_io_tpu_torch.reliability.retry import RetryPolicy, resilient_source


def shard_iterable(source: Iterable, shard_index: int, shard_count: int) -> Iterator:
    """Round-robin shard of a stream (what ``split_dataset_by_node`` does for
    non-sharded iterable datasets)."""
    for i, item in enumerate(source):
        if i % shard_count == shard_index:
            yield item


def window_shuffle(source: Iterable, window_size: int, seed: int) -> Iterator:
    """Buffered shuffle: maintain a ``window_size`` reservoir, emit a random
    element as each new one arrives (HF streaming ``dataset.shuffle``
    semantics, ``c4.py:78``)."""
    rng = random.Random(seed)
    buffer = []
    for item in source:
        if len(buffer) < window_size:
            buffer.append(item)
            continue
        j = rng.randrange(window_size)
        yield buffer[j]
        buffer[j] = item
    rng.shuffle(buffer)
    yield from buffer


class StreamingTextPipeline:
    """Token-stream chunker over any iterable of text records.

    :param source_fn: zero-arg callable returning a fresh text iterator
        (each epoch / retry re-invokes it).
    :param tokenizer: protocol tokenizer or name for :func:`load_tokenizer`.
    :param max_seq_len: chunk width is ``max_seq_len + 1`` (shift-by-one).
    :param min_seq_len: if set, each chunk keeps a random
        ``[min_seq_len, max_seq_len]`` prefix and pads the rest.
    :param shard_index/shard_count: this host's shard; default from
        ``host_shard_info``.
    :param retry_policy: survive transient source failures (HTTP hiccups on
        hub streams) by re-opening the source with exponential backoff and
        fast-forwarding past the records already consumed
        (:func:`~perceiver_io_tpu_torch.reliability.resilient_source`). None
        (default) fails fast like before.
    :param retry_sleep: backoff sleep hook (injectable for chaos tests).
    """

    def __init__(
        self,
        source_fn: Callable[[], Iterable[str]],
        tokenizer,
        max_seq_len: int,
        min_seq_len: Optional[int] = None,
        batch_size: int = 4,
        shuffle_window_size: int = 0,
        seed: int = 0,
        shard_index: Optional[int] = None,
        shard_count: Optional[int] = None,
        retry_policy: Optional[RetryPolicy] = None,
        retry_sleep: Callable[[float], None] = time.sleep,
    ):
        if isinstance(tokenizer, str):
            tokenizer = load_tokenizer(tokenizer)
        if shard_index is None or shard_count is None:
            auto_index, auto_count = host_shard_info()
            shard_index = auto_index if shard_index is None else shard_index
            shard_count = auto_count if shard_count is None else shard_count
        self.source_fn = source_fn
        self.tokenizer = tokenizer
        self.max_seq_len = max_seq_len
        self.min_seq_len = min_seq_len
        self.batch_size = batch_size
        self.shuffle_window_size = shuffle_window_size
        self.seed = seed
        self.shard_index = shard_index
        self.shard_count = shard_count
        self.retry_policy = retry_policy
        self.retry_sleep = retry_sleep

    def _chunks(self) -> Iterator[np.ndarray]:
        chunk_size = self.max_seq_len + 1
        if self.retry_policy is not None:
            # retry wraps the RAW source so a re-opened stream fast-forwards
            # in source order, before sharding/shuffling see any records
            source: Iterable = resilient_source(
                self.source_fn, self.retry_policy, sleep=self.retry_sleep
            )
        else:
            source = self.source_fn()
        source = shard_iterable(source, self.shard_index, self.shard_count)
        if self.shuffle_window_size:
            source = window_shuffle(source, self.shuffle_window_size, self.seed)
        eos = self.tokenizer.eos_token_id
        buf: list[int] = []
        for text in source:
            buf.extend(self.tokenizer.encode(text, add_special_tokens=False))
            if eos is not None:
                buf.append(eos)
            while len(buf) >= chunk_size:
                yield np.asarray(buf[:chunk_size], dtype=np.int32)
                del buf[:chunk_size]

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        rng = np.random.default_rng(self.seed)
        pad_id = self.tokenizer.pad_token_id or 0
        rows = []
        for chunk in self._chunks():
            rows.append(chunk)
            if len(rows) < self.batch_size:
                continue
            batch = np.stack(rows)
            rows = []
            ids = batch[:, :-1]
            labels = batch[:, 1:].astype(np.int32)
            pad_mask = np.zeros_like(ids, dtype=bool)
            if self.min_seq_len is not None:
                # static-shape version of the reference's random chunk length:
                # keep a random prefix per row, pad the tail.
                keep = rng.integers(self.min_seq_len, self.max_seq_len + 1, size=len(ids))
                cols = np.arange(ids.shape[1])[None, :]
                tail = cols >= keep[:, None]
                ids = np.where(tail, pad_id, ids)
                labels = np.where(tail, IGNORE_INDEX, labels)
                pad_mask = tail
            yield {
                "labels": labels,
                "input_ids": ids.astype(np.int32),
                "pad_mask": pad_mask,
            }


class C4DataModule:
    """C4-en streaming datamodule (reference ``C4DataModule``,
    ``c4.py:20-154``): streaming hub splits, window shuffle, per-host
    sharding, SentencePiece (or any HF) tokenizer."""

    def __init__(
        self,
        tokenizer: str = "google-t5/t5-small",
        max_seq_len: int = 1024,
        min_seq_len: Optional[int] = None,
        batch_size: int = 4,
        shuffle_window_seed: int = 0,
        shuffle_window_size: int = 10000,
        shard_index: Optional[int] = None,
        shard_count: Optional[int] = None,
        dataset_path: str = "allenai/c4",
        dataset_name: str = "en",
        source_max_retries: int = 3,
    ):
        self.tokenizer = load_tokenizer(tokenizer)
        self.max_seq_len = max_seq_len
        self.min_seq_len = min_seq_len
        self.batch_size = batch_size
        self.shuffle_window_seed = shuffle_window_seed
        self.shuffle_window_size = shuffle_window_size
        self.shard_index = shard_index
        self.shard_count = shard_count
        self.dataset_path = dataset_path
        self.dataset_name = dataset_name
        # hub streams fail transiently as a matter of course; retry them by
        # default (0 disables — fail fast)
        self.retry_policy = (
            RetryPolicy(max_retries=source_max_retries)
            if source_max_retries > 0
            else None
        )

    @property
    def vocab_size(self) -> int:
        return self.tokenizer.vocab_size

    def _hub_texts(self, split: str) -> Callable[[], Iterable[str]]:
        def source():
            from datasets import load_dataset

            ds = load_dataset(self.dataset_path, self.dataset_name, split=split, streaming=True)
            for record in ds:
                yield record["text"]

        return source

    def _pipeline(self, split: str, min_seq_len, shuffle: bool) -> StreamingTextPipeline:
        return StreamingTextPipeline(
            self._hub_texts(split),
            self.tokenizer,
            max_seq_len=self.max_seq_len,
            min_seq_len=min_seq_len,
            batch_size=self.batch_size,
            shuffle_window_size=self.shuffle_window_size if shuffle else 0,
            seed=self.shuffle_window_seed,
            shard_index=self.shard_index,
            shard_count=self.shard_count,
            retry_policy=self.retry_policy,
        )

    def train_dataloader(self) -> StreamingTextPipeline:
        return self._pipeline("train", self.min_seq_len, shuffle=True)

    def val_dataloader(self) -> StreamingTextPipeline:
        return self._pipeline("validation", None, shuffle=False)
