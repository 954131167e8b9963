"""Concrete text dataset modules. A copy of
``perceiver_io_tpu/data/text/sources.py`` (reference
``perceiver/data/text/{wikitext,imdb,enwik8,bookcorpus,wikipedia}.py``): each
only overrides :meth:`load_source_dataset`. Hub-backed sources import
``datasets`` lazily so the package works fully offline; :class:`ListDataModule`
feeds in-memory text (the test/offline path — the reference has no offline
equivalent, its tests download real IMDb subsets, SURVEY.md §4)."""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from perceiver_io_tpu_torch.data.text.datamodule import Task, TextDataModule


class ListDataModule(TextDataModule):
    """In-memory source: ``train_texts`` / ``valid_texts`` are lists of
    strings, or (text, label) behavior via ``train_labels``/``valid_labels``."""

    def __init__(
        self,
        train_texts: Sequence[str],
        valid_texts: Sequence[str],
        train_labels: Optional[Sequence[int]] = None,
        valid_labels: Optional[Sequence[int]] = None,
        test_texts: Optional[Sequence[str]] = None,
        test_labels: Optional[Sequence[int]] = None,
        num_classes: Optional[int] = None,
        **kwargs,
    ):
        super().__init__(**kwargs)
        self._train = (list(train_texts), list(train_labels) if train_labels else None)
        self._valid = (list(valid_texts), list(valid_labels) if valid_labels else None)
        self._test = (
            (list(test_texts), list(test_labels) if test_labels else None)
            if test_texts is not None
            else None
        )
        self._num_classes = num_classes

    @property
    def num_classes(self) -> Optional[int]:
        return self._num_classes

    def load_source_dataset(self) -> Dict[str, object]:
        def pack(texts, labels):
            return {"text": texts, "label": labels} if labels is not None else texts

        out = {"train": pack(*self._train), "valid": pack(*self._valid)}
        if self._test is not None:
            out["test"] = pack(*self._test)
        return out


class _HubDataModule(TextDataModule):
    """Shared plumbing for Hugging Face hub sources."""

    def __init__(self, dataset_dir: Optional[str] = None, **kwargs):
        super().__init__(dataset_dir=dataset_dir or os.path.join(".cache", self.cache_name), **kwargs)

    cache_name = "hub"

    def _load(self, path: str, name: Optional[str] = None, **kwargs):
        from datasets import load_dataset

        return load_dataset(path, name, cache_dir=self.dataset_dir, **kwargs)

    @staticmethod
    def _texts(split) -> List[str]:
        return split["text"]


class _CarvedTestSplit:
    """Mixin for sources that carve train/valid (and optionally test) from a
    single upstream split. The test slice is taken from just before the valid
    tail, so enabling it leaves the valid split byte-identical and only
    shrinks train — no leakage, no golden churn."""

    source_valid_size: float
    source_test_size: float

    def _carved_splits(self, texts, n_valid: int) -> Dict[str, object]:
        n_test = int(len(texts) * self.source_test_size)
        train_end = len(texts) - n_valid - n_test
        if train_end <= 0:
            raise ValueError(
                f"source_valid_size + source_test_size leave no training data "
                f"({len(texts)} docs, {n_valid} valid + {n_test} test) — "
                "negative slicing here would silently overlap the splits"
            )
        out = {"train": texts[:train_end], "valid": texts[len(texts) - n_valid:]}
        if n_test:
            out["test"] = texts[train_end: train_end + n_test]
        return out

    def preproc_dir_hash_input(self) -> str:
        key = super().preproc_dir_hash_input()  # type: ignore[misc]
        if self.source_test_size:
            key += f"|test:{self.source_test_size}"
        return key


class WikiTextDataModule(_HubDataModule):
    """wikitext-103-raw (reference ``wikitext.py:10-20``); the upstream
    ``test`` split is materialized for the CLI ``test`` subcommand."""

    cache_name = "wikitext"

    def load_source_dataset(self) -> Dict[str, object]:
        ds = self._load("wikitext", "wikitext-103-raw-v1")
        return {
            "train": self._texts(ds["train"]),
            "valid": self._texts(ds["validation"]),
            "test": self._texts(ds["test"]),
        }


class ImdbDataModule(_HubDataModule):
    """IMDb: clf uses train/test with labels; mlm/clm use unsupervised/test
    text only (reference ``imdb.py:10-33``)."""

    cache_name = "imdb"

    @property
    def num_classes(self) -> int:
        return 2

    def load_source_dataset(self) -> Dict[str, object]:
        # IMDb publishes no validation split; the reference evaluates on the
        # official test split as "valid" (``imdb.py:10-33``). The test split
        # here is that same official split, so the ``test`` subcommand
        # reports on exactly the protocol the reference's numbers use.
        ds = self._load("imdb", "plain_text")
        if self.task == Task.clf:
            official_test = {"text": ds["test"]["text"], "label": ds["test"]["label"]}
            return {
                "train": {"text": ds["train"]["text"], "label": ds["train"]["label"]},
                "valid": official_test,
                "test": official_test,
            }
        official_test = self._texts(ds["test"])  # one object: tokenized once
        return {
            "train": self._texts(ds["unsupervised"]),
            "valid": official_test,
            "test": official_test,
        }


class Enwik8DataModule(_CarvedTestSplit, _HubDataModule):
    """enwik8 with a train/valid split and per-line trailing newline
    (reference ``enwik8.py:10-37``)."""

    cache_name = "enwik8"

    def __init__(self, source_valid_size: float = 0.05, source_test_size: float = 0.0, **kwargs):
        self.source_valid_size = source_valid_size
        self.source_test_size = source_test_size
        super().__init__(**kwargs)

    def load_source_dataset(self) -> Dict[str, object]:
        ds = self._load("enwik8", "enwik8", split="train")
        texts = [t + "\n" for t in ds["text"]]
        return self._carved_splits(texts, int(len(texts) * self.source_valid_size))


class BookCorpusDataModule(_CarvedTestSplit, _HubDataModule):
    cache_name = "bookcorpus"

    def __init__(self, source_valid_size: float = 0.05, source_test_size: float = 0.0, **kwargs):
        self.source_valid_size = source_valid_size
        self.source_test_size = source_test_size
        super().__init__(**kwargs)

    def load_source_dataset(self) -> Dict[str, object]:
        ds = self._load("bookcorpus", split="train")
        texts = self._texts(ds)
        return self._carved_splits(texts, int(len(texts) * self.source_valid_size))


class BookCorpusOpenDataModule(_CarvedTestSplit, _HubDataModule):
    """bookcorpusopen: whole books, one record each (reference
    ``perceiver/data/text/bookcorpusopen.py``)."""

    cache_name = "bookcorpusopen"

    def __init__(self, source_valid_size: float = 0.05, source_test_size: float = 0.0, **kwargs):
        self.source_valid_size = source_valid_size
        self.source_test_size = source_test_size
        super().__init__(**kwargs)

    def load_source_dataset(self) -> Dict[str, object]:
        ds = self._load("bookcorpusopen", split="train")
        texts = self._texts(ds)
        return self._carved_splits(texts, max(1, int(len(texts) * self.source_valid_size)))


class WikipediaDataModule(_CarvedTestSplit, _HubDataModule):
    cache_name = "wikipedia"

    def __init__(
        self,
        config_name: str = "20220301.en",
        source_valid_size: float = 0.01,
        source_test_size: float = 0.0,
        **kwargs,
    ):
        self.config_name = config_name
        self.source_valid_size = source_valid_size
        self.source_test_size = source_test_size
        super().__init__(**kwargs)

    def load_source_dataset(self) -> Dict[str, object]:
        ds = self._load("wikipedia", self.config_name, split="train")
        texts = self._texts(ds)
        return self._carved_splits(texts, int(len(texts) * self.source_valid_size))


def markov_transition(rng) -> "np.ndarray":
    """The synthetic corpus's order-1 Markov transition matrix — the FIRST
    draw from the corpus rng (``default_rng(corpus_seed)``). Shared with the
    entropy-floor oracle (``examples/training/longrun.py``) so the floor can
    never silently diverge from the data it bounds: rows are
    ``dirichlet(0.3)`` over the 27-char alphabet (peaked → entropy well
    below uniform)."""
    k = len(SyntheticTextDataModule._ALPHABET)
    return rng.dirichlet(np.full(k, 0.3), size=k)


class SyntheticTextDataModule(TextDataModule):
    """Deterministic synthetic corpus — offline smoke runs, CI, and config
    dry-runs (no reference counterpart: the reference cannot train without
    downloading a dataset).

    For mlm/clm, documents are order-1 Markov character text over a seeded
    transition matrix: structured (entropy well below uniform) so a model
    can visibly learn, yet fully reproducible. For the clf task, each
    document samples words from one of two disjoint pools and the label is
    the pool index — linearly separable, so accuracy climbs within a few
    steps. Generation happens lazily in :meth:`load_source_dataset` (cache
    misses only), and the generation parameters are part of the preproc
    cache key — changing them regenerates instead of reusing stale arrays.
    """

    _ALPHABET = "abcdefghijklmnopqrstuvwxyz "

    def __init__(
        self,
        dataset_dir: str = ".cache/synthetic",
        num_train_docs: int = 64,
        num_valid_docs: int = 16,
        num_test_docs: Optional[int] = None,
        doc_chars: int = 2048,
        corpus_seed: int = 0,
        **kwargs,
    ):
        self.num_train_docs = num_train_docs
        self.num_valid_docs = num_valid_docs
        # default: a test split the size of valid (drawn after train/valid
        # from the same stream, so enabling it never changes those splits)
        self.num_test_docs = num_valid_docs if num_test_docs is None else num_test_docs
        self.doc_chars = doc_chars
        self.corpus_seed = corpus_seed
        task = kwargs.get("task", "mlm")
        self._clf = (task if isinstance(task, str) else getattr(task, "name", "mlm")) == "clf"
        super().__init__(dataset_dir=dataset_dir, **kwargs)
        self._num_classes = 2 if self._clf else None

    @property
    def num_classes(self):
        return self._num_classes

    def preproc_dir_hash_input(self) -> str:
        return (
            super().preproc_dir_hash_input()
            + f"|synthetic:{self.num_train_docs},{self.num_valid_docs},"
            + f"{self.doc_chars},{self.corpus_seed}"
            + (f",test:{self.num_test_docs}" if self.num_test_docs else "")
        )

    def load_source_dataset(self) -> Dict[str, object]:
        rng = np.random.default_rng(self.corpus_seed)
        if self._clf:
            pools = (
                ["alpha", "bravo", "carbon", "delta", "ember"],
                ["zinc", "yarrow", "xenon", "willow", "vortex"],
            )

            def split(n):
                labels = [int(i % 2) for i in range(n)]
                texts = [
                    " ".join(rng.choice(pools[l], size=max(1, self.doc_chars // 8)))
                    for l in labels
                ]
                return {"text": texts, "label": labels}

            out = {"train": split(self.num_train_docs), "valid": split(self.num_valid_docs)}
            if self.num_test_docs:
                out["test"] = split(self.num_test_docs)
            return out

        trans = markov_transition(rng)
        k = trans.shape[0]

        def doc():
            states = np.empty(self.doc_chars, np.int64)
            s = int(rng.integers(k))
            for i in range(self.doc_chars):
                s = int(rng.choice(k, p=trans[s]))
                states[i] = s
            return "".join(self._ALPHABET[c] for c in states)

        out = {
            "train": [doc() for _ in range(self.num_train_docs)],
            "valid": [doc() for _ in range(self.num_valid_docs)],
        }
        if self.num_test_docs:
            out["test"] = [doc() for _ in range(self.num_test_docs)]
        return out
