"""Text datamodule: tokenize → chunk → (mask) → cache, then task-specific
dataset views and loaders. A copy of ``perceiver_io_tpu/data/text/datamodule.py``
over the port's loader (:mod:`perceiver_io_tpu_torch.data.loader`): the cache
directory name and its ``.npy`` arrays are the JAX package's, so a cache
written by either package is read by the other, and the same seed gives the
same batches.

Mirrors the reference's ``TextDataModule`` pipeline
(``perceiver/data/text/common.py:55-361``) with a flat storage design:
after chunking, a split is a single ``(num_chunks, chunk_size)`` int32 array
saved as ``.npy`` and memory-mapped at load — no arrow/pyarrow layer, O(1)
random access, zero-copy slices into the collator. The cache directory is
keyed by an md5 of the preprocessing config, exactly the reference's scheme
(``common.py:164-188``).

Task pipelines (``common.py:255-272``):

- ``clm``: tokenize (no word ids) → chunk to ``max_seq_len + 1``; the
  :class:`CLMView` then yields the shift-by-one (input, label) pair.
- ``mlm``: tokenize with word ids → chunk to ``max_seq_len``; masking happens
  either dynamically in the collator or statically here.
- ``clf``: tokenize each document truncated to ``max_seq_len``, keep labels.
"""
from __future__ import annotations

import hashlib
import json
import os
from enum import Enum
from typing import Dict, List, Optional, Sequence

import numpy as np

from perceiver_io_tpu_torch.data.loader import DataLoader
from perceiver_io_tpu_torch.data.text.collators import (
    IGNORE_INDEX,
    NO_WORD,
    DefaultCollator,
    RandomTruncateCollator,
    TokenMaskingCollator,
    WordMaskingCollator,
)
from perceiver_io_tpu_torch.data.text.preprocessor import TextPreprocessor
from perceiver_io_tpu_torch.data.text.tokenizers import load_tokenizer


class Task(Enum):
    mlm = 0
    clm = 1
    clf = 2


class ChunkedTokenDataset:
    """A split after preprocessing: dense 2-D arrays, one row per example."""

    def __init__(
        self,
        input_ids: np.ndarray,
        word_ids: Optional[np.ndarray] = None,
        labels: Optional[np.ndarray] = None,
        lengths: Optional[np.ndarray] = None,
    ):
        self.input_ids = input_ids
        self.word_ids = word_ids
        self.labels = labels
        self.lengths = lengths

    def __len__(self) -> int:
        return len(self.input_ids)

    def __getitem__(self, idx: int) -> Dict:
        n = int(self.lengths[idx]) if self.lengths is not None else self.input_ids.shape[1]
        ex: Dict = {"input_ids": np.asarray(self.input_ids[idx][:n])}
        if self.word_ids is not None:
            ex["word_ids"] = np.asarray(self.word_ids[idx][:n])
        if self.labels is not None:
            if self.labels.ndim == 1:  # classification scalar
                ex["label"] = int(self.labels[idx])
            else:  # static-masking label ids
                ex["label_ids"] = np.asarray(self.labels[idx][:n])
        return ex


class RandomShiftView:
    """Example ``i`` = ``concat(rec[i][shift:], rec[i+1][:shift])`` with a
    random per-access shift — the reference's concatenation augmentation
    (``common.py:364-387``). Applies the same shift to every key."""

    def __init__(self, dataset, seed: int = 0):
        self.dataset = dataset
        self.rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self.dataset) - 1

    def __getitem__(self, idx: int) -> Dict:
        a, b = self.dataset[idx], self.dataset[idx + 1]
        shift = int(self.rng.integers(0, len(a["input_ids"])))
        return {
            k: np.concatenate([a[k][shift:], b[k][:shift]])
            for k in a
            if isinstance(a[k], np.ndarray)
        } | {k: v for k, v in a.items() if not isinstance(v, np.ndarray)}


class CLMView:
    """Shift-by-one view over ``max_seq_len + 1`` chunks (reference
    ``CLMDataset``, ``common.py:390-399``)."""

    def __init__(self, dataset):
        self.dataset = dataset

    def __len__(self) -> int:
        return len(self.dataset)

    def __getitem__(self, idx: int) -> Dict:
        ids = self.dataset[idx]["input_ids"]
        return {"input_ids": ids[:-1], "label_ids": ids[1:]}


class TextDataModule:
    """Base text datamodule. Subclasses implement :meth:`load_source_dataset`
    returning ``{"train": split, "valid": split}`` where a split is either a
    list of strings or a dict ``{"text": [...], "label": [...]}``.

    Constructor args mirror the reference's (``common.py:56-108``); loading
    knobs that are torch-specific (pin_memory, worker counts) are dropped —
    the loader prefetches on a thread and shards per host instead.
    """

    def __init__(
        self,
        dataset_dir: str,
        tokenizer: str = "byte",
        max_seq_len: int = 2048,
        task: Task = Task.mlm,
        mask_prob: float = 0.15,
        mask_words: bool = True,
        static_masking: bool = False,
        add_special_tokens: bool = False,
        add_eos_token: bool = False,
        padding_side: Optional[str] = None,
        random_train_shift: bool = False,
        random_valid_shift: bool = False,
        random_train_truncation: bool = False,
        random_valid_truncation: bool = False,
        random_min_seq_len: int = 16,
        batch_size: int = 64,
        valid_batch_size: Optional[int] = None,
        seed: int = 0,
    ):
        if static_masking and not mask_words:
            raise ValueError("static_masking=true is only supported for mask_words=true")
        if isinstance(task, str):
            task = Task[task]
        self.dataset_dir = dataset_dir
        self.tokenizer_name = tokenizer
        self.tokenizer = load_tokenizer(tokenizer, padding_side)
        self.max_seq_len = max_seq_len
        self.task = task
        self.mask_prob = mask_prob
        self.mask_words = mask_words
        self.static_masking = static_masking
        self.add_special_tokens = add_special_tokens
        self.add_eos_token = add_eos_token
        self.random_train_shift = random_train_shift
        self.random_valid_shift = random_valid_shift
        self.random_train_truncation = random_train_truncation
        self.random_valid_truncation = random_valid_truncation
        self.random_min_seq_len = random_min_seq_len
        self.batch_size = batch_size
        self.valid_batch_size = valid_batch_size or batch_size
        self.seed = seed
        self.ds_train = None
        self.ds_valid = None
        self.ds_test = None

    # -- source hook --------------------------------------------------------
    def load_source_dataset(self) -> Dict[str, object]:
        raise NotImplementedError

    @property
    def vocab_size(self) -> int:
        return self.tokenizer.vocab_size

    @property
    def num_classes(self) -> Optional[int]:
        return None

    @property
    def random_shift(self) -> bool:
        return self.random_train_shift or self.random_valid_shift

    # -- cache keying (reference common.py:164-188) -------------------------
    def preproc_dir_hash_input(self) -> str:
        key = f"{self.tokenizer_name}-{self.max_seq_len}-{self.task.name}-{self.random_shift}"
        if self.task == Task.mlm and self.static_masking:
            key += f"-{self.mask_words}-{self.mask_prob}"
        if self.add_special_tokens:
            key += "-st"
        if self.add_eos_token:
            key += "-eos"
        return key

    @property
    def preproc_dir(self) -> str:
        h = hashlib.md5(self.preproc_dir_hash_input().encode()).hexdigest()
        return os.path.join(self.dataset_dir, "preproc", h)

    # -- preprocessing ------------------------------------------------------
    def prepare_data(self) -> None:
        if os.path.exists(os.path.join(self.preproc_dir, "meta.json")):
            return
        source = self.load_source_dataset()
        os.makedirs(self.preproc_dir, exist_ok=True)
        meta = {"task": self.task.name, "splits": {}}
        prepared: Dict[int, Dict[str, np.ndarray]] = {}
        for split, data in source.items():
            # Sources may alias one object across splits (e.g. IMDb's valid
            # and test are both the official test split) — tokenize it once.
            if id(data) in prepared:
                arrays = prepared[id(data)]
            else:
                arrays = prepared.setdefault(id(data), self._prepare_split(data))
            for name, arr in arrays.items():
                np.save(os.path.join(self.preproc_dir, f"{split}.{name}.npy"), arr)
            meta["splits"][split] = {
                "num_examples": int(len(arrays["input_ids"])),
                "arrays": sorted(arrays),
            }
        with open(os.path.join(self.preproc_dir, "meta.json"), "w") as f:
            json.dump(meta, f)

    def _texts_and_labels(self, data) -> tuple[List[str], Optional[List[int]]]:
        if isinstance(data, dict):
            return list(data["text"]), list(data["label"]) if "label" in data else None
        return list(data), None

    def _prepare_split(self, data) -> Dict[str, np.ndarray]:
        texts, labels = self._texts_and_labels(data)
        if self.add_eos_token:
            eos = (
                self.tokenizer.decode([self.tokenizer.eos_token_id], skip_special_tokens=False)
                if self.tokenizer.eos_token_id is not None
                else ""
            )
        tok = self.tokenizer

        if self.task == Task.clf:
            assert labels is not None, "clf task requires labels in the source dataset"
            rows = [
                np.asarray(
                    tok.encode(t, add_special_tokens=self.add_special_tokens)[: self.max_seq_len],
                    dtype=np.int32,
                )
                for t in texts
            ]
            lengths = np.asarray([len(r) for r in rows], dtype=np.int32)
            ids = np.zeros((len(rows), self.max_seq_len), dtype=np.int32)
            for i, r in enumerate(rows):
                ids[i, : len(r)] = r
            return {
                "input_ids": ids,
                "lengths": lengths,
                "labels": np.asarray(labels, dtype=np.int32),
            }

        # clm / mlm: tokenize everything, concatenate, chunk.
        want_word_ids = self.task == Task.mlm
        chunk_size = self.max_seq_len + 1 if self.task == Task.clm else self.max_seq_len
        all_ids: List[np.ndarray] = []
        all_wids: List[np.ndarray] = []
        wid_base = 0
        for text in texts:
            if self.add_eos_token and self.tokenizer.eos_token_id is not None:
                ids = tok.encode(text, add_special_tokens=self.add_special_tokens)
                ids = ids + [self.tokenizer.eos_token_id]
            else:
                ids = tok.encode(text, add_special_tokens=self.add_special_tokens)
            all_ids.append(np.asarray(ids, dtype=np.int32))
            if want_word_ids:
                wids = tok.word_ids(ids)
                arr = np.asarray(
                    [NO_WORD if w is None else w + wid_base for w in wids], dtype=np.int64
                )
                # offset so words never collide across documents
                wid_base = int(arr.max()) + 2 if len(arr) and arr.max() >= 0 else wid_base
                all_wids.append(arr)

        flat_ids = np.concatenate(all_ids) if all_ids else np.zeros(0, np.int32)
        n_chunks = len(flat_ids) // chunk_size
        ids = flat_ids[: n_chunks * chunk_size].reshape(n_chunks, chunk_size)
        out = {"input_ids": ids}
        if want_word_ids:
            flat_wids = np.concatenate(all_wids)
            out["word_ids"] = flat_wids[: n_chunks * chunk_size].reshape(n_chunks, chunk_size)
        if self.task == Task.mlm and self.static_masking:
            wmc = WordMaskingCollator(tok, self.mask_prob, seed=self.seed)
            masked = np.empty_like(out["input_ids"])
            labels_arr = np.empty_like(out["input_ids"])
            for i in range(n_chunks):
                masked[i], labels_arr[i] = wmc.mask_example(out["input_ids"][i], out["word_ids"][i])
            out["input_ids"] = masked
            out["labels"] = labels_arr
            del out["word_ids"]
        return out

    # -- load + views -------------------------------------------------------
    def _load_split(self, split: str) -> ChunkedTokenDataset:
        def load(name):
            path = os.path.join(self.preproc_dir, f"{split}.{name}.npy")
            return np.load(path, mmap_mode="r") if os.path.exists(path) else None

        return ChunkedTokenDataset(
            input_ids=load("input_ids"),
            word_ids=load("word_ids"),
            labels=load("labels"),
            lengths=load("lengths"),
        )

    def setup(self) -> None:
        self.ds_train = self._load_split("train")
        self.ds_valid = self._load_split("valid")
        if os.path.exists(os.path.join(self.preproc_dir, "test.input_ids.npy")):
            # Deterministic: no random shift/truncation views on test.
            self.ds_test = self._load_split("test")
        if self.task in (Task.clm, Task.mlm):
            if self.random_train_shift:
                self.ds_train = RandomShiftView(self.ds_train, seed=self.seed)
            if self.random_valid_shift:
                self.ds_valid = RandomShiftView(self.ds_valid, seed=self.seed + 1)
        if self.task == Task.clm:
            self.ds_train = CLMView(self.ds_train)
            self.ds_valid = CLMView(self.ds_valid)
            if self.ds_test is not None:
                self.ds_test = CLMView(self.ds_test)

    # -- collator / loaders (reference common.py:127-139,206-234) -----------
    def _base_collator(self):
        if self.task == Task.mlm and not self.static_masking:
            cls = WordMaskingCollator if self.mask_words else TokenMaskingCollator
            return cls(self.tokenizer, self.mask_prob, seed=self.seed)
        return DefaultCollator(self.tokenizer, max_seq_len=self.max_seq_len)

    def _loader(self, dataset, batch_size, shuffle, truncate, seed) -> DataLoader:
        collator = self._base_collator()
        if truncate:
            collator = RandomTruncateCollator(collator, self.random_min_seq_len, seed=seed)
        return DataLoader(
            dataset, batch_size=batch_size, shuffle=shuffle, seed=seed, collate_fn=collator
        )

    def train_dataloader(self) -> DataLoader:
        return self._loader(
            self.ds_train, self.batch_size, True, self.random_train_truncation, self.seed
        )

    def val_dataloader(self) -> DataLoader:
        return self._loader(
            self.ds_valid, self.valid_batch_size, False, self.random_valid_truncation, self.seed + 1
        )

    def test_dataloader(self) -> DataLoader:
        """Deterministic pass over the test split (CLI ``test`` subcommand,
        reference LightningCLI fit/validate/test parity,
        ``perceiver/scripts/cli.py:13-48``)."""
        if self.ds_test is None:
            raise ValueError(
                f"{type(self).__name__} materialized no test split — either "
                "the source dataset provides none (source_test_size=0), or "
                f"the preproc cache at {self.preproc_dir} predates test-split "
                "support; in the latter case delete it and re-run preproc"
            )
        return self._loader(self.ds_test, self.valid_batch_size, False, False, self.seed + 2)

    def text_preprocessor(self) -> TextPreprocessor:
        return TextPreprocessor(
            self.tokenizer, max_seq_len=self.max_seq_len, add_special_tokens=self.add_special_tokens
        )
