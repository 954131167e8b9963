"""Map-style batch loader with per-epoch shuffles, host sharding,
prefetch, retry and an O(1) resume skip. Counterpart of
``perceiver_io_tpu/data/loader.py``: the same seed gives the same batches,
because the shuffle is numpy's (``default_rng(seed + epoch)``).

Batches are dicts of numpy arrays; the train step moves them onto the
device (``parallel.train_step.to_device``).
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Dict, Iterator, Optional, Sequence

import numpy as np

from perceiver_io_tpu_torch.reliability.retry import RetryPolicy, call_with_retry


def host_shard_info() -> tuple[int, int]:
    """``(shard_index, shard_count)`` of this process: its
    ``torch.distributed`` rank and world size when a process group is up,
    else ``(0, 1)``."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def default_collate(examples: Sequence[Dict[str, Any]]) -> Dict[str, np.ndarray]:
    """Stack same-keyed example dicts into a batch dict."""
    out = {}
    for key in examples[0]:
        out[key] = np.stack([np.asarray(e[key]) for e in examples], axis=0)
    return out


class DataLoader:
    """Map-style loader: ``dataset[i] -> example dict``, collated into batches.

    :param dataset: anything with ``__len__`` and ``__getitem__``.
    :param batch_size: per-host batch size (global batch = batch_size ×
        shard_count when every host runs its own loader).
    :param shuffle: reshuffle the index space every epoch.
    :param seed: base RNG seed; epoch ``e`` uses ``seed + e`` so ordering is
        reproducible and differs between epochs.
    :param shard_index/shard_count: this host's slice of the index space.
        Defaults to :func:`host_shard_info`. Sharding happens *after* the
        epoch shuffle so every host sees a disjoint, epoch-varying subset.
    :param drop_last: drop the trailing partial batch (keeps every batch
        the same shape, as ``steps_per_execution`` blocks need; default True).
    :param collate_fn: ``examples -> batch dict``; default stacks arrays.
    :param prefetch: number of batches buffered on a background thread
        (0 disables threading).
    :param retry_policy: retry transient per-example fetch failures with
        exponential backoff (:class:`~perceiver_io_tpu_torch.reliability.RetryPolicy`)
        instead of killing the run — for datasets backed by remote/flaky
        storage. None (default) fails fast like before.
    :param retry_sleep: backoff sleep hook (injectable for deterministic
        chaos tests).
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = False,
        seed: int = 0,
        shard_index: Optional[int] = None,
        shard_count: Optional[int] = None,
        drop_last: bool = True,
        collate_fn: Optional[Callable] = None,
        prefetch: int = 2,
        retry_policy: Optional[RetryPolicy] = None,
        retry_sleep: Callable[[float], None] = time.sleep,
    ):
        if shard_index is None or shard_count is None:
            auto_index, auto_count = host_shard_info()
            shard_index = auto_index if shard_index is None else shard_index
            shard_count = auto_count if shard_count is None else shard_count
        if not 0 <= shard_index < shard_count:
            raise ValueError(f"invalid shard {shard_index}/{shard_count}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.shard_index = shard_index
        self.shard_count = shard_count
        self.drop_last = drop_last
        self.collate_fn = collate_fn or default_collate
        self.prefetch = prefetch
        self.retry_policy = retry_policy
        self.retry_sleep = retry_sleep
        self._epoch = 0
        self._start_batch = 0

    def _fetch(self, i: int):
        if self.retry_policy is None:
            return self.dataset[i]
        return call_with_retry(
            lambda: self.dataset[i], self.retry_policy, sleep=self.retry_sleep
        )

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def skip_batches(self, n: int) -> None:
        """Advance the stream position by ``n`` batches in O(1) — the
        resume fast-forward hook (the trainer uses this instead of
        materializing and discarding ``n`` batches when available). The
        position lands exactly where a continuous iteration would be:
        ``n // len(self)`` epochs ahead, ``n % len(self)`` batches in."""
        per_epoch = len(self)
        if per_epoch == 0 or n <= 0:
            return
        self._epoch += n // per_epoch
        self._start_batch = n % per_epoch

    def _epoch_indices(self) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            order = np.random.default_rng(self.seed + self._epoch).permutation(n)
        else:
            order = np.arange(n)
        return order[self.shard_index :: self.shard_count]

    def __len__(self) -> int:
        n = len(self._epoch_indices())
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _batches(self) -> Iterator[Dict[str, np.ndarray]]:
        indices = self._epoch_indices()
        limit = len(indices)
        if self.drop_last:
            limit = (limit // self.batch_size) * self.batch_size
        first = self._start_batch * self.batch_size
        self._start_batch = 0
        for start in range(first, limit, self.batch_size):
            chunk = indices[start : start + self.batch_size]
            if not len(chunk):
                return
            yield self.collate_fn([self._fetch(int(i)) for i in chunk])
        self._epoch += 1  # auto-advance so re-iteration reshuffles

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        if self.prefetch <= 0:
            yield from self._batches()
            return
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        err: list = []

        def worker():
            try:
                for batch in self._batches():
                    q.put(batch)
            except BaseException as e:  # surface worker errors in the consumer
                err.append(e)
            finally:
                q.put(sentinel)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is sentinel:
                break
            yield item
        t.join()
        if err:
            raise err[0]
