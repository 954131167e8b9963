"""Symbolic-audio data modules: MIDI dirs -> flat int16 token stream ->
random-window samples -> static left/right-padded shift-by-one batches.
Counterpart of ``perceiver_io_tpu/data/audio/symbolic.py``, itself after the
upstream project's (its "reference"): the same seeds draw the same windows
from numpy generators, so the batches are equal.

- **storage**: every encoded piece is appended to one flat ``int16`` array
  with ``-1`` separators between pieces, saved as ``train.bin``/``valid.bin``
  memmaps: O(1) random access into the token stream.
- **sampling**: a sample is a random window of ``max_seq_len + 1`` tokens;
  if it crosses piece boundaries, the longest separator-free span is kept;
  with ``min_seq_len`` set, the span is further truncated to a random length
  (the curriculum over sequence lengths).
- **collation**: pad to ``max_seq_len + 1`` on the configured side, then emit
  the shift-by-one ``{"labels": x[1:], "input_ids": x[:-1], "pad_mask"}``
  dict of numpy arrays (static shapes), which the train step moves onto the
  device.

Sampling uses a seeded generator per dataset (reproducible across restarts).
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from perceiver_io_tpu_torch.data.audio.midi import (
    PAD_TOKEN,
    SEPARATOR,
    VOCAB_SIZE,
    encode_midi_files,
)
from perceiver_io_tpu_torch.data.loader import DataLoader
from perceiver_io_tpu_torch.training.tasks import IGNORE_INDEX


class SymbolicAudioDataset:
    """Random windows over the flat separator-delimited token stream."""

    def __init__(
        self,
        data: np.ndarray,
        max_seq_len: int,
        *,
        min_seq_len: Optional[int] = None,
        seed: int = 0,
    ):
        if data.shape[0] <= max_seq_len + 1:
            raise ValueError(
                f"token stream of {data.shape[0]} tokens is too short for "
                f"max_seq_len={max_seq_len}"
            )
        self._data = data
        self._window = max_seq_len + 1  # +1 for the shift-by-one view
        self._min_window = min_seq_len + 1 if min_seq_len is not None else None
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return self._data.shape[0] // self._window

    def __getitem__(self, index) -> Dict:
        start = int(self._rng.integers(0, self._data.shape[0] - self._window))
        sample = np.asarray(self._data[start : start + self._window], np.int64)

        if (sample == SEPARATOR).any():
            # longest separator-free span (reference symbolic.py:173-183)
            bounds = np.flatnonzero(sample == SEPARATOR)
            edges = np.concatenate([[-1], bounds, [len(sample)]])
            spans = [
                sample[edges[i] + 1 : edges[i + 1]]
                for i in range(len(edges) - 1)
            ]
            sample = max(spans, key=len)

        if self._min_window is not None and self._min_window < len(sample):
            length = int(self._rng.integers(self._min_window, self._window))
            sample = sample[:length]
        return {"input_ids": sample}


class SymbolicAudioCollator:
    """Pad to ``max_seq_len + 1``, emit shift-by-one dict (reference
    ``symbolic.py:194-232``; pad labels become ``IGNORE_INDEX`` so the loss
    mask needs no separate plumbing)."""

    def __init__(self, max_seq_len: int, padding_side: str = "left"):
        if padding_side not in ("left", "right"):
            raise ValueError(f"invalid padding side '{padding_side}'")
        self._width = max_seq_len + 1
        self._side = padding_side

    def __call__(self, examples: Sequence[Dict]) -> Dict[str, np.ndarray]:
        rows = np.full((len(examples), self._width), PAD_TOKEN, np.int32)
        for r, example in enumerate(examples):
            ids = example["input_ids"][: self._width]
            if self._side == "left":
                rows[r, self._width - len(ids) :] = ids
            else:
                rows[r, : len(ids)] = ids
        input_ids = rows[:, :-1]
        labels = rows[:, 1:].astype(np.int32)
        pad_mask = input_ids == PAD_TOKEN
        labels = np.where(labels == PAD_TOKEN, IGNORE_INDEX, labels)
        return {"labels": labels, "input_ids": input_ids, "pad_mask": pad_mask}


class SymbolicAudioDataModule:
    """Reference ``SymbolicAudioDataModule`` (``symbolic.py:16-157``).

    Subclasses (or callers) provide the source MIDI directories via
    :meth:`load_source_dataset`; :meth:`from_token_streams` injects already
    encoded streams (tests, custom corpora).
    """

    vocab_size: int = VOCAB_SIZE

    def __init__(
        self,
        dataset_dir: str,
        max_seq_len: int,
        *,
        min_seq_len: Optional[int] = None,
        padding_side: str = "left",
        batch_size: int = 16,
        preproc_workers: int = 1,
        seed: int = 0,
        shard_index: Optional[int] = None,
        shard_count: Optional[int] = None,
    ):
        if min_seq_len is not None and not 0 < min_seq_len < max_seq_len:
            raise ValueError("need 0 < min_seq_len < max_seq_len")
        self.dataset_dir = Path(dataset_dir)
        self.max_seq_len = max_seq_len
        self.min_seq_len = min_seq_len
        self.padding_side = padding_side
        self.batch_size = batch_size
        self.preproc_workers = preproc_workers
        self.seed = seed
        self.shard_index = shard_index
        self.shard_count = shard_count
        self._splits: Dict[str, np.ndarray] = {}

    # -- sourcing ----------------------------------------------------------
    @property
    def preproc_dir(self) -> Path:
        return self.dataset_dir / "preproc"

    def load_source_dataset(self) -> Dict[str, object]:
        """Return ``{"train": ..., "valid": ...}`` (optionally ``"test"``)
        MIDI sources.

        Each value is either a directory (``rglob``-ed for ``.mid``/``.midi``)
        or an explicit list of files (manifest- or bucket-derived splits).
        Splits must be disjoint — overlap leaks training data into
        evaluation and makes the metrics meaningless.
        """
        raise NotImplementedError

    def split_signature(self) -> str:
        """Configuration that determines split *membership* (not content).
        Stored in the preproc manifest; a cache built under a different
        signature is refused instead of silently reusing wrong splits.
        Default "" matches caches written before this hook existed."""
        return ""

    @staticmethod
    def _midi_files(source) -> List[Path]:
        if isinstance(source, (list, tuple)):
            return sorted(Path(f) for f in source)
        midi_dir = Path(source)
        return sorted(midi_dir.rglob("**/*.mid")) + sorted(midi_dir.rglob("**/*.midi"))

    @classmethod
    def from_token_streams(
        cls,
        train: np.ndarray,
        valid: np.ndarray,
        max_seq_len: int,
        test: Optional[np.ndarray] = None,
        **kwargs,
    ) -> "SymbolicAudioDataModule":
        dm = cls(dataset_dir=".", max_seq_len=max_seq_len, **kwargs)
        dm._splits = {
            "train": np.asarray(train, np.int16),
            "valid": np.asarray(valid, np.int16),
        }
        if test is not None:
            dm._splits["test"] = np.asarray(test, np.int16)
        return dm

    @staticmethod
    def flatten_pieces(pieces: List[np.ndarray], shuffle_seed: Optional[int] = None) -> np.ndarray:
        """Concatenate encoded pieces with separators (reference
        ``symbolic.py:117-118``)."""
        if shuffle_seed is not None:
            order = np.random.default_rng(shuffle_seed).permutation(len(pieces))
            pieces = [pieces[i] for i in order]
        parts = [np.append(p.astype(np.int16), np.int16(SEPARATOR)) for p in pieces]
        return np.concatenate(parts)

    def prepare_data(self) -> None:
        if self._splits:
            return
        if self.preproc_dir.exists():
            import json

            # Caches written before disjoint splits existed have no manifest
            # and were built with train == valid — refuse to reuse them.
            manifest_file = self.preproc_dir / "split_manifest.json"
            if not manifest_file.exists():
                raise ValueError(
                    f"{self.preproc_dir} was built by an older version with "
                    "overlapping train/valid splits (no split_manifest.json); "
                    "delete it and re-run preprocessing"
                )
            stored = json.loads(manifest_file.read_text()).get("_signature", "")
            if stored != self.split_signature():
                raise ValueError(
                    f"{self.preproc_dir} was preprocessed under a different "
                    f"split configuration ({stored!r} vs "
                    f"{self.split_signature()!r}) — reusing it would mix "
                    "split memberships; delete it and re-run preprocessing"
                )
            return
        sources = self.load_source_dataset()
        names = [s for s in ("train", "valid", "test") if s in sources]
        split_files = {s: self._midi_files(sources[s]) for s in names}
        for a in names:
            for b in names:
                if a >= b:
                    continue
                overlap = set(map(str, split_files[a])) & set(map(str, split_files[b]))
                if overlap:
                    raise ValueError(
                        f"{a}/{b} splits overlap on {len(overlap)} files "
                        f"(e.g. {sorted(overlap)[0]}) — evaluation would leak "
                        "training data"
                    )
        os.makedirs(self.preproc_dir)
        for split in names:
            files = split_files[split]
            pieces = encode_midi_files(files, num_workers=self.preproc_workers)
            flat = self.flatten_pieces(
                pieces, shuffle_seed=self.seed if split == "train" else None
            )
            fp = np.memmap(
                self.preproc_dir / f"{split}.bin", np.int16, mode="w+", shape=flat.shape
            )
            fp[:] = flat
            fp.flush()
        import json

        manifest = {s: [str(f) for f in split_files[s]] for s in names}
        manifest["_signature"] = self.split_signature()
        (self.preproc_dir / "split_manifest.json").write_text(json.dumps(manifest))

    def setup(self) -> None:
        if self._splits:
            return
        self._splits = {
            split: np.memmap(self.preproc_dir / f"{split}.bin", np.int16, mode="r")
            for split in ("train", "valid", "test")
            if (self.preproc_dir / f"{split}.bin").exists()
        }

    # -- loaders -----------------------------------------------------------
    def _loader(self, split: str, min_seq_len: Optional[int]) -> DataLoader:
        dataset = SymbolicAudioDataset(
            self._splits[split],
            self.max_seq_len,
            min_seq_len=min_seq_len,
            seed=self.seed,
        )
        return DataLoader(
            dataset,
            batch_size=self.batch_size,
            shuffle=False,  # samples are already random windows
            drop_last=True,
            collate_fn=SymbolicAudioCollator(self.max_seq_len, self.padding_side),
            seed=self.seed,
            shard_index=self.shard_index,
            shard_count=self.shard_count,
        )

    def train_dataloader(self) -> DataLoader:
        return self._loader("train", self.min_seq_len)

    def val_dataloader(self) -> DataLoader:
        # validation always uses full windows (reference symbolic.py:133-137)
        return self._loader("valid", None)

    def test_dataloader(self) -> DataLoader:
        if "test" not in self._splits:
            raise ValueError(
                f"{type(self).__name__} materialized no test split — either "
                "the source provides none, or the preproc cache at "
                f"{self.preproc_dir} predates test-split support; in the "
                "latter case delete it and re-run preprocessing"
            )
        return self._loader("test", None)


class MaestroV3DataModule(SymbolicAudioDataModule):
    """MAESTRO v3 piano corpus: expects the extracted archive at
    ``<dataset_dir>/maestro-v3.0.0`` (zero-egress images cannot download;
    point ``dataset_dir`` at a local copy).

    Splits follow the official ``maestro-v3.0.0.json`` manifest exactly as
    the reference does (``maestro_v3.py:58-76``): columnar
    ``metadata["midi_filename"]``/``metadata["split"]``, ``train`` → train,
    ``validation`` → valid, and ``test`` → the test split (which the
    reference discards; here it feeds ``test_dataloader``).
    """

    def load_source_dataset(self) -> Dict[str, List[Path]]:
        import json

        root = self.dataset_dir / "maestro-v3.0.0"
        if not root.exists():
            raise FileNotFoundError(
                f"{root} not found — place the extracted MAESTRO v3 archive there"
            )
        meta_file = root / "maestro-v3.0.0.json"
        if not meta_file.exists():
            raise FileNotFoundError(f"missing MAESTRO manifest {meta_file}")
        with open(meta_file) as f:
            metadata = json.load(f)
        splits: Dict[str, List[Path]] = {"train": [], "valid": [], "test": []}
        names = {"train": "train", "validation": "valid", "test": "test"}
        for _id, file_path in metadata["midi_filename"].items():
            splits[names[metadata["split"][_id]]].append(root / file_path)
        return splits


class GiantMidiPianoDataModule(SymbolicAudioDataModule):
    """GiantMIDI-Piano corpus: expects MIDI files under ``<dataset_dir>/midis``.

    The reference's hosted archive ships pre-split ``train``/``valid``
    directories (``giantmidi_piano.py:38-47``); when those exist they are
    used as-is. A flat ``midis`` directory (the upstream GiantMIDI layout)
    is split deterministically by filename hash instead: ``valid`` = files
    whose ``crc32(name) % num_buckets == valid_bucket`` — stable across runs
    and machines, and disjoint from train by construction.
    """

    valid_bucket: int = 0
    #: hash bucket carved out as the test split; ``None`` (default) keeps the
    #: historical train/valid layout byte-identical (no test split).
    test_bucket: Optional[int] = None
    num_buckets: int = 10

    def split_signature(self) -> str:
        # "" for the historical default so pre-existing caches stay valid.
        if (self.valid_bucket, self.test_bucket, self.num_buckets) == (0, None, 10):
            return ""
        return f"buckets:{self.valid_bucket},{self.test_bucket},{self.num_buckets}"

    def load_source_dataset(self) -> Dict[str, object]:
        root = self.dataset_dir / "midis"
        if not root.exists():
            raise FileNotFoundError(f"{root} not found — place GiantMIDI midis there")
        train_dir, valid_dir = root / "train", root / "valid"
        if train_dir.exists() and valid_dir.exists():
            out = {"train": train_dir, "valid": valid_dir}
            if (root / "test").exists():
                out["test"] = root / "test"
            return out
        if train_dir.exists() or valid_dir.exists():
            raise ValueError(
                f"{root} has only one of train/valid — a partially extracted "
                "pre-split archive; hash-splitting it would discard the "
                "curated split. Restore both directories or remove the one."
            )
        import zlib

        files = self._midi_files(root)
        if self.test_bucket is not None and self.test_bucket == self.valid_bucket:
            raise ValueError("test_bucket must differ from valid_bucket")
        buckets = [zlib.crc32(f.name.encode()) % self.num_buckets for f in files]
        out = {
            "train": [
                f for f, b in zip(files, buckets)
                if b != self.valid_bucket and b != self.test_bucket
            ],
            "valid": [f for f, b in zip(files, buckets) if b == self.valid_bucket],
        }
        if self.test_bucket is not None:
            out["test"] = [f for f, b in zip(files, buckets) if b == self.test_bucket]
        return out


class SyntheticSymbolicAudioDataModule(SymbolicAudioDataModule):
    """Deterministic synthetic event streams — offline smoke runs and config
    dry-runs (no reference counterpart; Maestro/GiantMIDI must download).
    Pieces are order-1 Markov walks over a seeded transition structure on the
    MIDI event vocab, so the next-event task is learnable, and piece lengths
    vary so separator/window handling is exercised."""

    def __init__(
        self,
        max_seq_len: int,
        *,
        dataset_dir: str = ".cache/synthetic_sam",
        num_train_pieces: int = 24,
        num_valid_pieces: int = 8,
        num_test_pieces: int = 8,
        mean_piece_len: int = 4096,
        **kwargs,
    ):
        super().__init__(dataset_dir=dataset_dir, max_seq_len=max_seq_len, **kwargs)
        self._gen = (num_train_pieces, num_valid_pieces, num_test_pieces, mean_piece_len)

    def prepare_data(self) -> None:  # nothing to download or encode
        pass

    def setup(self) -> None:
        if self._splits:
            return
        num_train, num_valid, num_test, mean_piece_len = self._gen
        rng = np.random.default_rng(self.seed)
        # sparse row-peaked transitions: each event strongly prefers a few
        # successors, so the stream has learnable structure
        successors = rng.integers(0, VOCAB_SIZE - 1, size=(VOCAB_SIZE, 4))

        def piece():
            n = int(rng.integers(mean_piece_len // 2, mean_piece_len * 3 // 2))
            out = np.empty(n, np.int16)
            s = int(rng.integers(VOCAB_SIZE - 1))
            for i in range(n):
                s = int(successors[s, rng.integers(4)]) if rng.random() < 0.9 else int(
                    rng.integers(VOCAB_SIZE - 1)
                )
                out[i] = s
            return out

        self._splits = {
            "train": self.flatten_pieces([piece() for _ in range(num_train)],
                                         shuffle_seed=self.seed),
            "valid": self.flatten_pieces([piece() for _ in range(num_valid)]),
        }
        if num_test:
            # drawn after train/valid from the same stream: enabling the
            # test split never changes the other two
            self._splits["test"] = self.flatten_pieces(
                [piece() for _ in range(num_test)]
            )
